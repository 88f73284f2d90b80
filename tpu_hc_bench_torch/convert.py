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

It takes the other ResNet trees the same way: ``BasicBlock_i``
(resnet18/34 and the CIFAR resnets: ``Conv_0..1``/``BatchNorm_0..1``)
and ``PreactBottleneckBlock_i`` (the v2 members: ``BatchNorm_0`` is the
preactivation ``bn1``, then ``Conv_0``, ``BatchNorm_1``, ...), with
``bn_init`` where the tree has it and the v2 ``bn_final``.

``vit_params_from_flax(params)`` takes a ``ViT`` tree: ``patchify``
(conv kernel and bias), ``cls`` and ``pos_embed`` unchanged, each
``layer_i`` through ``decoder_layer_params_from_flax``, ``ln_f`` and
the transposed ``head``.

``zoo_variables_from_flax(name, params, batch_stats)`` takes the tree of
any image member (by registry name, alias or family: ``trivial``,
``alexnet``, ``vgg``, ``lenet``, ``overfeat``, ``googlenet``,
``mobilenet``, ``densenet``, ``inception``, ``nasnet``, the resnets, the
ViTs) and returns its ``state_dict``.  Past the resnets and the ViTs the
rule is one walk over the tree: each module path renamed segment by
segment through the family's table (Flax's auto-names such as
``InceptionModule_3`` or ``ConvBN_2`` to the port's lists,
``inception.3``, ``convs.2``; explicit names map unchanged), and each
leaf by its kind: a 4-D ``kernel`` (HWIO, depthwise ``[kh, kw, 1, C]``
too) to an OIHW ``weight``, a 2-D one (Dense ``[in, out]``) transposed,
``bias``, ``scale`` to ``weight``, ``mean``/``var`` to
``running_mean``/``running_var``.

``deepspeech2_variables_from_flax(params, batch_stats)`` takes a
``DeepSpeech2`` tree of any ``rnn_impl`` arm and returns the
``state_dict`` of the port's ``models.deepspeech.DeepSpeech2``, whose
one layout serves the three arms: ``conv1``/``conv2`` (HWIO to OIHW),
``conv{1,2}_bn`` and ``rnn{i}_bn`` (scale, bias, mean, var) to
``conv{1,2}_bn`` and ``rnn_bns.{i}``, ``ctc_head`` transposed, and each
layer's two directions to ``grus.{i}.{fwd,bwd}`` (``input_gates``
transposed to ``[3H, I]``, ``hidden_gates [H, 3H]`` and
``candidate_bias`` unchanged), from

- ``hoisted``: ``gru{i}_{fwd,bwd}/{input_gates,hidden_gates,
  candidate_bias}``;
- ``bidi``: ``bigru{i}/{fwd,bwd}_{input_gates,hidden_gates,
  candidate_bias}``;
- ``flax``: the cells at the top level, ``GRUCell_{2i}`` forward and
  ``GRUCell_{2i+1}`` backward, each ``ir/iz/in`` (kernels ``[I, H]`` and
  biases, concatenated in gate order to the input gates) and
  ``hr/hz/hn`` (kernels ``[H, H]`` concatenated to the hidden gates;
  ``hn``'s bias is the candidate bias).

``ncf_params_from_flax(params)`` takes a ``NeuMF`` tree: the four
``*.embedding`` tables unchanged, ``mlp_{i}`` to ``mlp.{i}`` and
``head``, their kernels transposed.

``sharded_params_from_flax(name, params, size, index, mode)`` carries a
transformer member's tree (``bert_*``, ``gpt2*`` and the MoE members,
``llama_*``, ``vit_*``) into one rank's shard of the port's tensor- or
expert-parallel model: the member's converter above, then
``parallel.tensor``'s rules cut each split parameter for rank ``index``
of ``size`` (what ``parallel.tensor.shard_model_`` does to a full
model).

Every ``*_from_flax`` consumes each leaf of the trees it is given or
raises: a leaf with no rule, or a tree with leaves left over.
"""

from __future__ import annotations

import re

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


def _leaves(tree: dict, path: tuple = ()):
    """``(path, leaf)`` of every leaf of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _check_consumed(sd: dict, *trees, merged: int = 0) -> None:
    """Each converter maps one leaf to one ``state_dict`` entry, or
    ``merged`` more leaves into entries of several: a tree with more
    leaves than that holds leaves it left."""
    n = sum(1 for t in trees if t for _ in _leaves(t))
    if n != len(sd) + merged:
        raise ValueError(f"the Flax tree has {n} leaves, of which the "
                         f"converter consumed {len(sd) + merged}")


_RESNET_BLOCKS = ("FusedBottleneckBlock_", "PreactBottleneckBlock_",
                  "BottleneckBlock_", "BasicBlock_")


def resnet_variables_from_flax(params: dict,
                               batch_stats: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    stem = "conv_init_s2d" if "conv_init_s2d" in params else "conv_init"
    sd[stem + ".weight"] = _conv(params[stem]["kernel"])
    for name in ("bn_init", "bn_final"):
        if name in params:
            _bn(sd, name + ".", params[name], batch_stats[name])
    prefix = next((p for p in _RESNET_BLOCKS
                   if any(k.startswith(p) for k in params)), None)
    n_blocks = (sum(1 for k in params if k.startswith(prefix))
                if prefix else 0)
    for i in range(n_blocks):
        block = resnet_block_from_flax(params[f"{prefix}{i}"],
                                       batch_stats[f"{prefix}{i}"])
        sd.update({f"blocks.{i}.{k}": v for k, v in block.items()})
    sd["head.weight"] = _t(np.asarray(params["head"]["kernel"]).T)
    sd["head.bias"] = _t(params["head"]["bias"])
    _check_consumed(sd, params, batch_stats)
    return sd


def vit_params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    sd = {"patchify.weight": _conv(params["patchify"]["kernel"]),
          "patchify.bias": _t(params["patchify"]["bias"]),
          "cls": _t(params["cls"]), "pos_embed": _t(params["pos_embed"]),
          "head.weight": _t(np.asarray(params["head"]["kernel"]).T),
          "head.bias": _t(params["head"]["bias"])}
    _layer_norm(sd, "ln_f.", params["ln_f"])
    sd = _finish(sd, [decoder_layer_params_from_flax(p)
                      for p in layer_trees(params)], params)
    _check_consumed(sd, params)
    return sd


# per family: (Flax module name pattern, port name) for the segments the
# port names otherwise; every other segment keeps its name
_INCEPTION_RENAMES = (
    (r"ConvBN_(\d+)", r"convs.\1"), ("Conv_0", "conv"), ("BatchNorm_0", "bn"),
    ("StemV4_0", "stem"),
    (r"InceptionA4?_(\d+)", r"inception_a.\1"),
    (r"InceptionB4_(\d+)", r"inception_b.\1"),
    (r"InceptionC4?_(\d+)", r"inception_c.\1"),
    (r"InceptionE_(\d+)", r"inception_e.\1"),
    (r"ReductionA4_(\d+)", r"reduction_a.\1"),
    (r"ReductionB4?_(\d+)", r"reduction_b.\1"),
    (r"ReductionD_(\d+)", r"reduction_d.\1"))
_ZOO_RENAMES = {
    "trivial": (("Dense_0", "head"),),
    "googlenet": ((r"InceptionModule_(\d+)", r"inception.\1"),),
    "inception": _INCEPTION_RENAMES,
    "alexnet": (), "vgg": (), "lenet": (), "overfeat": (), "mobilenet": (),
    "densenet": (), "nasnet": (),
}
_ZOO_FAMILY = (("vit", "vit"), ("resnet", "resnet"), ("vgg", "vgg"),
               ("inception", "inception"), ("nasnet", "nasnet"),
               ("densenet", "densenet"), ("lenet", "lenet"),
               ("mobilenet", "mobilenet"))
_LEAF_RULES = {("params", "bias"): "bias", ("params", "scale"): "weight",
               ("params", "kernel"): "weight",
               ("batch_stats", "mean"): "running_mean",
               ("batch_stats", "var"): "running_var"}


def _rename(segment: str, renames) -> str:
    for pattern, port in renames:
        if re.fullmatch(pattern, segment):
            return re.sub(pattern, port, segment)
    return segment


def _zoo_leaf(col: str, path: tuple, leaf) -> torch.Tensor:
    a = np.asarray(leaf)
    if path[-1] != "kernel":
        return _t(a.reshape(-1))
    if a.ndim == 4:
        return _conv(a)
    if a.ndim == 2:
        return _t(a.T)
    raise ValueError(f"{col}/{'/'.join(path)}: a kernel of shape "
                     f"{a.shape} has no rule")


def zoo_family(name: str) -> str:
    """The converter family of an image member (registry name or alias),
    or ``name`` itself where it names a family."""
    key = name.lower()
    if key in _ZOO_RENAMES:
        return key
    for stem, family in _ZOO_FAMILY:
        if stem in key:
            return family
    raise ValueError(f"no image converter for {name!r}")


def zoo_variables_from_flax(name: str, params: dict,
                            batch_stats: dict | None = None
                            ) -> dict[str, torch.Tensor]:
    family = zoo_family(name)
    if family == "resnet":
        return resnet_variables_from_flax(params, batch_stats or {})
    if family == "vit":
        return vit_params_from_flax(params)
    renames = _ZOO_RENAMES[family]
    sd: dict[str, torch.Tensor] = {}
    for col, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, leaf in _leaves(tree or {}):
            rule = _LEAF_RULES.get((col, path[-1]))
            if rule is None:
                raise ValueError(f"{col}/{'/'.join(path)}: no rule for "
                                 f"this leaf in the {family} converter")
            key = ".".join([_rename(seg, renames) for seg in path[:-1]]
                           + [rule])
            sd[key] = _zoo_leaf(col, path, leaf)
    _check_consumed(sd, params, batch_stats)
    return sd


def _gru_direction(sd: dict, pre: str, input_gates: dict, hidden_gates,
                   candidate_bias) -> None:
    sd[pre + "input_gates.weight"] = _t(np.asarray(input_gates["kernel"]).T)
    sd[pre + "input_gates.bias"] = _t(input_gates["bias"])
    sd[pre + "hidden_gates"] = _t(hidden_gates)
    sd[pre + "candidate_bias"] = _t(candidate_bias)


def _flax_cell(cell: dict) -> tuple:
    """A Flax ``GRUCell``'s six Denses as ``(input_gates, hidden_gates,
    candidate_bias)`` in the hoisted layout, gate order ``[r | z | n]``."""
    gates = ("r", "z", "n")
    kernel = np.concatenate([np.asarray(cell["i" + g]["kernel"])
                             for g in gates], 1)
    bias = np.concatenate([np.asarray(cell["i" + g]["bias"])
                           for g in gates])
    hidden = np.concatenate([np.asarray(cell["h" + g]["kernel"])
                             for g in gates], 1)
    return {"kernel": kernel, "bias": bias}, hidden, cell["hn"]["bias"]


def deepspeech2_variables_from_flax(params: dict, batch_stats: dict
                                    ) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for name in ("conv1", "conv2"):
        sd[name + ".weight"] = _conv(params[name]["kernel"])
        _bn(sd, f"{name}_bn.", params[f"{name}_bn"],
            batch_stats[f"{name}_bn"])
    layers = sum(1 for k in params if re.fullmatch(r"rnn\d+_bn", k))
    merged = 0
    for i in range(layers):
        _bn(sd, f"rnn_bns.{i}.", params[f"rnn{i}_bn"],
            batch_stats[f"rnn{i}_bn"])
        for d, direction in enumerate(("fwd", "bwd")):
            pre = f"grus.{i}.{direction}."
            if f"gru{i}_{direction}" in params:              # hoisted
                p = params[f"gru{i}_{direction}"]
                _gru_direction(sd, pre, p["input_gates"], p["hidden_gates"],
                               p["candidate_bias"])
            elif f"bigru{i}" in params:                       # bidi
                p = params[f"bigru{i}"]
                _gru_direction(sd, pre, p[f"{direction}_input_gates"],
                               p[f"{direction}_hidden_gates"],
                               p[f"{direction}_candidate_bias"])
            else:                                             # flax
                cell = params[f"GRUCell_{2 * i + d}"]
                _gru_direction(sd, pre, *_flax_cell(cell))
                merged += 10 - 4  # six Denses: ten leaves, four entries
    sd["ctc_head.weight"] = _t(np.asarray(params["ctc_head"]["kernel"]).T)
    sd["ctc_head.bias"] = _t(params["ctc_head"]["bias"])
    _check_consumed(sd, params, batch_stats, merged=merged)
    return sd


def ncf_params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    sd = {f"{name}.weight": _t(params[name]["embedding"])
          for name in ("mf_user", "mf_item", "mlp_user", "mlp_item")}
    dense = sorted((k for k in params if re.fullmatch(r"mlp_\d+", k)),
                   key=lambda k: int(k.split("_")[1]))
    for name, port in [(k, "mlp." + k.split("_")[1]) for k in dense] + [
            ("head", "head")]:
        sd[port + ".weight"] = _t(np.asarray(params[name]["kernel"]).T)
        sd[port + ".bias"] = _t(params[name]["bias"])
    _check_consumed(sd, params)
    return sd


def sharded_params_from_flax(name: str, params: dict, size: int,
                             index: int, mode: str = "tp"
                             ) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of rank ``index``'s shard (of ``size``) of the
    port's tensor-parallel (``mode="tp"``) or expert-parallel (``"ep"``)
    model ``name``, from its Flax tree."""
    from tpu_hc_bench_torch.parallel import tensor

    if name.startswith("bert"):
        sd = bert_params_from_flax(params)
    elif name.startswith("llama"):
        sd = llama_params_from_flax(params)
    elif name.startswith("vit"):
        sd = vit_params_from_flax(params)
    elif name.startswith(("gpt", "moe")):
        sd = gpt_params_from_flax(params)
    else:
        raise ValueError(f"{name} has no tensor-parallel layout")
    out = {}
    for k, v in sd.items():
        rule = tensor.tp_param_rule(k, v.dim(), mode)
        out[k] = v if rule is None else tensor.cut(v, rule, size, index)
    return out


def pp_stage_params_from_flax(name: str, params: dict, stages: int,
                              stage: int, size: int = 1, index: int = 0
                              ) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of pipeline stage ``stage`` of ``stages`` of the
    decoder ``name`` (``create_model(pipeline=(stages, stage))``), from
    its Flax tree, unrolled (``layer_<i>``) or stacked for JAX's pipeline
    (``parallel.pipeline.stack_layer_params``: ``trunk`` ``[L, ...]``):
    the stage's layers ``cut_stage`` renamed ``layers.<i - lo>``, the
    whole embedding and head, each tensor cut to model rank ``index`` of
    ``size`` (DP x PP x TP)."""
    from tpu_hc_bench_torch.parallel import pipeline, tensor

    if "trunk" in params:
        rest = {k: v for k, v in params.items() if k != "trunk"}
        leaf = params["trunk"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        params = {**rest, **{f"layer_{i}": _slice_tree(params["trunk"], i)
                             for i in range(np.asarray(leaf).shape[0])}}
    if name.startswith("llama"):
        sd = llama_params_from_flax(params)
    elif name.startswith(("gpt", "moe")):
        sd = gpt_params_from_flax(params)
    else:
        raise ValueError(f"{name} has no pipeline layout")
    num_layers = len(layer_trees(params))
    lo, hi = pipeline.cut_stage(num_layers, stages, stage)
    out = {}
    for k, v in sd.items():
        m = pipeline._LAYER.fullmatch(k)
        if m is not None:
            i = int(m.group(1))
            if not lo <= i < hi:
                continue
            k = f"layers.{i - lo}.{m.group(2)}"
        rule = tensor.tp_param_rule(k, v.dim())
        out[k] = v if rule is None or size == 1 else tensor.cut(
            v, rule, size, index)
    return out
