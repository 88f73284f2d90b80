"""Model registry of the port: the ``--model=`` dispatch, for the members
ported so far (``llama_1b`` and ``llama_tiny``).

``get_model_spec`` and ``create_model`` keep the JAX package's names and
return values (``create_model`` returns ``(model, spec)``); the port's
``create_model`` also places the model on its device and initialises
its weights from ``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.models import llama


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    create: Callable[[], torch.nn.Module]
    vocab_size: int
    causal_lm: bool = False


def _registry() -> dict[str, ModelSpec]:
    specs = [
        ModelSpec("llama_1b", llama.llama_1b, vocab_size=32000,
                  causal_lm=True),
        ModelSpec("llama_tiny", llama.llama_tiny, vocab_size=1024,
                  causal_lm=True),
    ]
    return {s.name: s for s in specs}


def get_model_spec(name: str) -> ModelSpec:
    reg = _registry()
    key = name.lower()
    if key not in reg:
        raise ValueError(f"unknown model {name!r}; the port has "
                         f"{sorted(reg)}")
    return reg[key]


def create_model(name: str, dtype=torch.float32,
                 attention_impl: str = "dense", *,
                 device: str | torch.device = "cuda", seed: int = 0):
    """``(model, spec)``: the model built on ``device`` with its weights
    drawn from a ``torch.Generator`` seeded with ``seed`` (on the same
    device, so a full-width model never passes through host memory)."""
    if dtype != torch.float32:
        raise ValueError(f"the port serves float32 only: {dtype}")
    if attention_impl != "dense":
        raise ValueError(f"--attention_impl={attention_impl} is not ported "
                         "yet (dense only)")
    spec = get_model_spec(name)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = spec.create()
    model = model.to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.init_weights(gen)
    return model.eval(), spec
