"""Carry weights from the JAX package's Flax param trees to the port.

``llama_params_from_flax(params)`` takes a ``LlamaLM`` Flax param tree
(unrolled ``layer_i`` layout) whose leaves are numpy arrays and returns
the ``state_dict`` of the port's ``models.llama.LlamaLM``.  It needs
neither JAX nor Flax: the caller converts the leaves with ``np.asarray``.

Layout rules:

- ``tok_embed.embedding [V, H]`` maps unchanged;
- ``attn.w{q,k,v}.kernel [H, n, d]`` maps to Linear weights ``[n*d, H]``;
- ``attn.wo.kernel [n, d, H]`` maps to ``[H, n*d]``;
- ``gate``/``up``/``down`` ``.kernel [in, out]`` are transposed;
- ``*.scale`` maps to the RMSNorm weight;
- ``lm_head [H, V]`` keeps the JAX orientation.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))   # a copy


def llama_params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    if "layers" in params:
        raise ValueError("scan_layers param trees (stacked layers/...) "
                         "are not servable; convert an unrolled layer_i "
                         "tree")
    sd = {"tok_embed.weight": _t(params["tok_embed"]["embedding"]),
          "final_norm.weight": _t(params["final_norm"]["scale"]),
          "lm_head": _t(params["lm_head"])}
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        p = params[f"layer_{i}"]
        a = p["attn"]
        pre = f"layers.{i}."
        for name in ("wq", "wk", "wv"):
            k = np.asarray(a[name]["kernel"])              # [H, n, d]
            sd[pre + f"attn.{name}.weight"] = _t(
                k.reshape(k.shape[0], -1).T)
        wo = np.asarray(a["wo"]["kernel"])                # [n, d, H]
        sd[pre + "attn.wo.weight"] = _t(wo.reshape(-1, wo.shape[-1]).T)
        for name in ("gate", "up", "down"):
            sd[pre + f"{name}.weight"] = _t(
                np.asarray(p[name]["kernel"]).T)
        sd[pre + "attn_norm.weight"] = _t(p["attn_norm"]["scale"])
        sd[pre + "mlp_norm.weight"] = _t(p["mlp_norm"]["scale"])
    return sd
