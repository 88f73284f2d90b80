"""Model registry of the port: the ``--model=`` dispatch, for the members
ported so far (``llama_1b`` and ``llama_tiny`` for serving; ``resnet50``,
``resnet101`` and ``resnet152`` for training).

``get_model_spec`` and ``create_model`` keep the JAX package's names and
return values (``create_model`` returns ``(model, spec)``); the port's
``create_model`` also places the model on its device and initialises
its weights from ``seed``.  ``flops_per_example`` is the forward FLOP
count at ``input_shape`` (2 x multiply-adds), the JAX registry's figure,
used for MFU (a train step is ~3x the forward).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.models import llama, resnet


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    create: Callable[..., torch.nn.Module]
    vocab_size: int = 0                # text models: token space
    causal_lm: bool = False
    input_shape: tuple[int, ...] = ()  # per example; (H, W, C) for images
    num_classes: int = 0               # image models: label space
    flops_per_example: float = 0.0     # forward FLOPs at input_shape
    fused_conv: bool = False           # factory takes fused_conv (the
                                       # fused BN-relu-conv3x3 kernel)


def _registry() -> dict[str, ModelSpec]:
    image = dict(input_shape=(224, 224, 3), num_classes=1000,
                 fused_conv=True)
    specs = [
        ModelSpec("llama_1b", llama.llama_1b, vocab_size=32000,
                  causal_lm=True),
        ModelSpec("llama_tiny", llama.llama_tiny, vocab_size=1024,
                  causal_lm=True),
        # ResNet v1.5 forward FLOPs at 224^2 (2 x MACs), the JAX figures
        ModelSpec("resnet50", resnet.resnet50, flops_per_example=8.2e9,
                  **image),
        ModelSpec("resnet101", resnet.resnet101, flops_per_example=15.7e9,
                  **image),
        ModelSpec("resnet152", resnet.resnet152, flops_per_example=23.1e9,
                  **image),
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
                 device: str | torch.device = "cuda", seed: int = 0,
                 fused_conv: bool = False, train: bool = False,
                 num_classes: int | None = None,
                 space_to_depth: bool = False):
    """``(model, spec)``: the model built on ``device`` with its weights
    drawn from a ``torch.Generator`` seeded with ``seed`` (on the same
    device, so a full-width model never passes through host memory), in
    training mode when ``train``.  Image models keep float32 parameters
    and compute in ``dtype`` (float32 or bfloat16), in ``channels_last``
    memory."""
    spec = get_model_spec(name)
    if spec.causal_lm:
        if dtype != torch.float32:
            raise ValueError(f"the port serves float32 only: {dtype}")
        if attention_impl != "dense":
            raise ValueError(f"--attention_impl={attention_impl} is not "
                             "ported yet (dense only)")
        if fused_conv or train or space_to_depth:
            raise ValueError(f"{name}: only serving (no fused_conv, train "
                             "or space_to_depth) is ported")
        factory = spec.create
    else:
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"image models compute in float32|bfloat16: "
                             f"{dtype}")
        factory = lambda: spec.create(                  # noqa: E731
            num_classes=num_classes or spec.num_classes, dtype=dtype,
            space_to_depth=space_to_depth, fused_conv=fused_conv)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = factory()
    model = model.to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.init_weights(gen)
    if not spec.causal_lm:
        model = model.to(memory_format=torch.channels_last)
    return model.train(train), spec
