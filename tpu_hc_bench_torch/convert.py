"""Carry weights from the JAX package's Flax variable trees to the port.

The converters take trees whose leaves are numpy arrays (the caller
converts them with ``np.asarray``) and return a port ``state_dict``; they
need neither JAX nor Flax.

Scanned trees (``--scan_layers``: one ``layers`` subtree whose every leaf
is stacked ``[L, ...]``) convert too.  The decoder converters keep the
tree's own layout: a stacked tree gives the ``state_dict`` of the port's
scanned model, ``layers.<name> [L, ...]``; each layer's slice follows the
rules below, and ``models.layer_stack.stack_state_dict`` stacks them
(``unstack_state_dict`` gives the unrolled layout back).

``llama_params_from_flax(params)`` takes a ``LlamaLM`` Flax param tree
and returns the ``state_dict`` of the port's ``models.llama.LlamaLM``,
for serving and training alike.  Layout rules:

- ``tok_embed.embedding [V, H]`` maps unchanged;
- ``attn.w{q,k,v}.kernel [H, n, d]`` maps to Linear weights ``[n*d, H]``;
- ``attn.wo.kernel [n, d, H]`` maps to ``[H, n*d]``;
- ``gate``/``up``/``down`` ``.kernel [in, out]`` are transposed;
- ``*.scale`` maps to the RMSNorm weight;
- ``lm_head [H, V]`` keeps the JAX orientation.

``gpt_params_from_flax(params)`` takes a ``GPTLM`` Flax param tree
(dense MLP or MoE) and returns the ``state_dict`` of the port's
``models.gpt.GPTLM``.  Layout rules:

- ``wte``/``wpe`` ``.embedding`` map to the ``nn.Embedding`` weights;
- LayerNorm ``scale``/``bias`` (``ln1``, ``ln2``, ``ln_f``) map to
  ``weight``/``bias``;
- ``MultiHeadAttention_0/qkv.kernel [H, 3, n, d]`` maps to ``[3*n*d, H]``
  and its bias ``[3, n, d]`` to ``[3*n*d]``;
  ``MultiHeadAttention_0/out.kernel [n, d, H]`` maps to ``[H, n*d]``;
- ``fc``/``proj`` ``.kernel [in, out]`` are transposed;
- an MoE layer's ``moe/router.kernel [H, E]`` is transposed to
  ``moe.router.weight [E, H]``; the expert-major ``moe/wi [E, H, F]`` and
  ``moe/wo [E, F, H]`` map unchanged.

It is built from ``decoder_layer_params_from_flax`` (one ``layer_i``) and
``attention_params_from_flax`` (one ``MultiHeadAttention_0``), which
convert those modules alone.

``bert_params_from_flax(params)`` takes a ``BertMLM`` Flax param tree
(unrolled ``layer_i`` layout) and returns the ``state_dict`` of the
port's ``models.bert.BertMLM``.  Layout rules:

- ``tok_embed``/``pos_embed`` ``.embedding`` map to the ``nn.Embedding``
  weights, ``LayerNorm_0`` (after the embeddings) to ``ln_embed``;
- per layer, ``MultiHeadAttention_0`` maps as above to ``attn``,
  ``LayerNorm_0``/``LayerNorm_1`` to ``ln1``/``ln2`` and
  ``Dense_0``/``Dense_1`` (transposed) to ``fc``/``proj``;
- ``mlm_dense`` (transposed) and ``mlm_ln`` keep their names, and
  ``mlm_bias [V]`` maps unchanged.

``resnet_variables_from_flax(params, batch_stats)`` takes a Flax
``ResNet`` (v1 bottleneck family) tree in either layout, unfused
(``BottleneckBlock_i``) or fused (``FusedBottleneckBlock_i``), and
returns the ``state_dict`` of the port's ``models.resnet.ResNet``, whose
one layout serves both routes.  Layout rules:

- conv ``kernel [kh, kw, in, out]`` (HWIO) maps to ``weight [out, in, kh,
  kw]`` (OIHW);
- BN ``scale``/``bias`` map to ``weight``/``bias``, ``batch_stats``
  ``mean``/``var`` to the buffers ``running_mean``/``running_var``;
- ``head.kernel [in, out]`` is transposed to the Linear ``[out, in]``;
- per block, unfused ``Conv_0..2``/``BatchNorm_0..2`` are
  ``conv1..3``/``bn1..3``; fused, ``Conv_0`` is ``conv1``,
  ``FusedBNReluConv3x3_0`` holds ``bn1`` (scale, bias, mean, var) and
  ``conv2`` (kernel), ``StatsBatchNorm_0`` is ``bn2``, and ``Conv_1`` and
  ``BatchNorm_0`` are the block's *third* conv and BN; ``shortcut_conv``
  and ``shortcut_bn`` keep their names.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_hc_bench_torch.models.layer_stack import stack_state_dict


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))   # a copy


def _slice_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def layer_trees(params: dict) -> list[dict]:
    """The trunk's per-layer trees, in order: ``layer_<i>`` of an
    unrolled tree, or the slices ``i`` of a scanned tree's ``layers``."""
    if "layers" in params:
        leaf = params["layers"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        return [_slice_tree(params["layers"], i)
                for i in range(np.asarray(leaf).shape[0])]
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    return [params[f"layer_{i}"] for i in range(n_layers)]


def _finish(sd: dict, layers: list[dict],
            params: dict) -> dict[str, torch.Tensor]:
    """``sd`` plus the converted layers, stacked where ``params`` is."""
    for i, layer in enumerate(layers):
        sd.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    if "layers" in params:
        return stack_state_dict(sd, len(layers))
    return sd


def llama_layer_params_from_flax(p: dict) -> dict[str, torch.Tensor]:
    """One ``LlamaBlock``: the ``state_dict`` of the port's block."""
    sd: dict[str, torch.Tensor] = {}
    a = p["attn"]
    for name in ("wq", "wk", "wv"):
        k = np.asarray(a[name]["kernel"])                   # [H, n, d]
        sd[f"attn.{name}.weight"] = _t(k.reshape(k.shape[0], -1).T)
    wo = np.asarray(a["wo"]["kernel"])                      # [n, d, H]
    sd["attn.wo.weight"] = _t(wo.reshape(-1, wo.shape[-1]).T)
    for name in ("gate", "up", "down"):
        sd[f"{name}.weight"] = _t(np.asarray(p[name]["kernel"]).T)
    sd["attn_norm.weight"] = _t(p["attn_norm"]["scale"])
    sd["mlp_norm.weight"] = _t(p["mlp_norm"]["scale"])
    return sd


def llama_params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    sd = {"tok_embed.weight": _t(params["tok_embed"]["embedding"]),
          "final_norm.weight": _t(params["final_norm"]["scale"]),
          "lm_head": _t(params["lm_head"])}
    return _finish(sd, [llama_layer_params_from_flax(p)
                        for p in layer_trees(params)], params)


def _dense(sd: dict, pre: str, p: dict) -> None:
    """A Flax Dense/DenseGeneral whose kernel's leading axis is the input
    (``[in, *out]``) as a ``[prod(out), in]`` weight and flat bias."""
    k = np.asarray(p["kernel"])
    sd[pre + "weight"] = _t(k.reshape(k.shape[0], -1).T)
    sd[pre + "bias"] = _t(np.asarray(p["bias"]).reshape(-1))


def _layer_norm(sd: dict, pre: str, p: dict) -> None:
    sd[pre + "weight"] = _t(p["scale"])
    sd[pre + "bias"] = _t(p["bias"])


def attention_params_from_flax(p: dict) -> dict[str, torch.Tensor]:
    """One ``MultiHeadAttention`` (``qkv``, ``out``): the ``state_dict``
    of the port's ``models.bert.MultiHeadAttention``."""
    sd: dict[str, torch.Tensor] = {}
    _dense(sd, "qkv.", p["qkv"])
    wo = np.asarray(p["out"]["kernel"])                     # [n, d, H]
    sd["out.weight"] = _t(wo.reshape(-1, wo.shape[-1]).T)
    sd["out.bias"] = _t(p["out"]["bias"])
    return sd


def moe_params_from_flax(p: dict) -> dict[str, torch.Tensor]:
    """One ``MoEFFN`` (``router``, ``wi``, ``wo``): the ``state_dict`` of
    the port's ``models.moe.MoEFFN``."""
    return {"router.weight": _t(np.asarray(p["router"]["kernel"]).T),
            "wi": _t(p["wi"]), "wo": _t(p["wo"])}


def decoder_layer_params_from_flax(p: dict) -> dict[str, torch.Tensor]:
    """One ``DecoderLayer`` (dense MLP or MoE): the ``state_dict`` of the
    port's ``models.gpt.DecoderLayer``."""
    sd = {"attn." + k: v for k, v in
          attention_params_from_flax(p["MultiHeadAttention_0"]).items()}
    for name in ("ln1", "ln2"):
        _layer_norm(sd, name + ".", p[name])
    if "moe" in p:
        sd.update({"moe." + k: v
                   for k, v in moe_params_from_flax(p["moe"]).items()})
    else:
        for name in ("fc", "proj"):
            _dense(sd, name + ".", p[name])
    return sd


def gpt_params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    sd = {"wte.weight": _t(params["wte"]["embedding"]),
          "wpe.weight": _t(params["wpe"]["embedding"])}
    _layer_norm(sd, "ln_f.", params["ln_f"])
    return _finish(sd, [decoder_layer_params_from_flax(p)
                        for p in layer_trees(params)], params)


def bert_layer_params_from_flax(p: dict) -> dict[str, torch.Tensor]:
    """One ``TransformerLayer``: the ``state_dict`` of the port's
    ``models.bert.TransformerLayer``."""
    sd = {"attn." + k: v for k, v in
          attention_params_from_flax(p["MultiHeadAttention_0"]).items()}
    for flax_name, port in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
        _layer_norm(sd, port + ".", p[flax_name])
    for flax_name, port in (("Dense_0", "fc"), ("Dense_1", "proj")):
        _dense(sd, port + ".", p[flax_name])
    return sd


def bert_params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    sd = {"tok_embed.weight": _t(params["tok_embed"]["embedding"]),
          "pos_embed.weight": _t(params["pos_embed"]["embedding"]),
          "mlm_bias": _t(params["mlm_bias"])}
    _layer_norm(sd, "ln_embed.", params["LayerNorm_0"])
    _dense(sd, "mlm_dense.", params["mlm_dense"])
    _layer_norm(sd, "mlm_ln.", params["mlm_ln"])
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        for k, v in bert_layer_params_from_flax(params[f"layer_{i}"]).items():
            sd[f"layers.{i}.{k}"] = v
    return sd


def _conv(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))     # HWIO -> OIHW


def _bn(sd: dict, pre: str, p: dict, stats: dict) -> None:
    sd[pre + "weight"] = _t(p["scale"])
    sd[pre + "bias"] = _t(p["bias"])
    sd[pre + "running_mean"] = _t(stats["mean"])
    sd[pre + "running_var"] = _t(stats["var"])


# block child -> port name: (Flax module holding the conv kernel or the
# BN params and stats, port child)
_UNFUSED = (("Conv_0", "conv1"), ("BatchNorm_0", "bn1"),
            ("Conv_1", "conv2"), ("BatchNorm_1", "bn2"),
            ("Conv_2", "conv3"), ("BatchNorm_2", "bn3"))
_FUSED = (("Conv_0", "conv1"), ("FusedBNReluConv3x3_0", "bn1"),
          ("FusedBNReluConv3x3_0", "conv2"), ("StatsBatchNorm_0", "bn2"),
          ("Conv_1", "conv3"), ("BatchNorm_0", "bn3"))
_SHORTCUT = (("shortcut_conv", "shortcut_conv"),
             ("shortcut_bn", "shortcut_bn"))


def resnet_block_from_flax(params: dict,
                           batch_stats: dict) -> dict[str, torch.Tensor]:
    """One bottleneck block's tree (either layout) as the port block's
    ``state_dict``."""
    fused = "FusedBNReluConv3x3_0" in params
    sd: dict[str, torch.Tensor] = {}
    for flax_name, port in (_FUSED if fused else _UNFUSED) + _SHORTCUT:
        if flax_name not in params:
            continue
        if port.startswith(("conv", "shortcut_conv")):
            sd[port + ".weight"] = _conv(params[flax_name]["kernel"])
        else:
            _bn(sd, port + ".", params[flax_name], batch_stats[flax_name])
    return sd


def resnet_variables_from_flax(params: dict,
                               batch_stats: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    stem = "conv_init_s2d" if "conv_init_s2d" in params else "conv_init"
    sd[stem + ".weight"] = _conv(params[stem]["kernel"])
    _bn(sd, "bn_init.", params["bn_init"], batch_stats["bn_init"])
    fused = any(k.startswith("FusedBottleneckBlock_") for k in params)
    prefix = "FusedBottleneckBlock_" if fused else "BottleneckBlock_"
    n_blocks = sum(1 for k in params if k.startswith(prefix))
    for i in range(n_blocks):
        block = resnet_block_from_flax(params[f"{prefix}{i}"],
                                       batch_stats[f"{prefix}{i}"])
        sd.update({f"blocks.{i}.{k}": v for k, v in block.items()})
    sd["head.weight"] = _t(np.asarray(params["head"]["kernel"]).T)
    sd["head.bias"] = _t(params["head"]["bias"])
    return sd
