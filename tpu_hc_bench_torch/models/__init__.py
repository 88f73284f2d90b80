"""Model registry of the port: the ``--model=`` dispatch, for the members
ported so far (``resnet50``, ``resnet101``, ``resnet152``, ``gpt2``,
``gpt2_medium``, the MoE members ``gpt2_moe`` and ``moe_tiny``,
``llama_1b``, ``llama_tiny``, ``bert_base``, ``bert_large`` and
``bert_tiny`` for training; the serving lane serves every ``causal_lm``
member: the llamas, ``gpt2``, ``gpt2_medium`` and the MoE members).

``get_model_spec`` and ``create_model`` keep the JAX package's names and
return values (``create_model`` returns ``(model, spec)``); the port's
``create_model`` also places the model on its device and initialises
its weights from ``seed``.  ``flops_per_example`` is the forward FLOP
count at ``input_shape`` (2 x multiply-adds), the JAX registry's figure,
used for MFU (a train step is ~3x the forward); a text model's
``seq_len`` override rescales it linearly and grows the position table,
as the JAX ``create_model`` does.  ``gradient_checkpointing`` (every
transformer), ``scan_layers`` (the decoder families) and the MoE knobs
(the MoE members) follow the JAX ``create_model``'s guards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.models import bert, gpt, llama, resnet
from tpu_hc_bench_torch.models.moe import MOE_IMPLS


# a text model's dropout stream is seeded apart from its weights' stream
DROPOUT_SEED_OFFSET = 1


def dropout_seed(seed: int, rank: int = 0) -> int:
    """The dropout generator's seed on data-parallel rank ``rank``:
    ``seed + DROPOUT_SEED_OFFSET`` on rank 0 (a one-worker run's), a
    draw from ``(seed, rank)`` on the others, so every worker draws its
    own masks as JAX's step folds the axis index into its dropout key."""
    if rank == 0:
        return seed + DROPOUT_SEED_OFFSET
    return int(np.random.SeedSequence(
        [seed + DROPOUT_SEED_OFFSET, rank]).generate_state(1)[0])


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
    is_text: bool = False              # token input; input_shape = (seq,)
    moe: bool = False                  # factory takes the MoE knobs


def _registry() -> dict[str, ModelSpec]:
    image = dict(input_shape=(224, 224, 3), num_classes=1000,
                 fused_conv=True)
    specs = [
        # decoder families: 2 x params x seq forward FLOPs, the JAX
        # figures (the MoE members count the active parameters a token)
        ModelSpec("llama_1b", llama.llama_1b, vocab_size=32000,
                  causal_lm=True, is_text=True, input_shape=(2048,),
                  flops_per_example=2 * 1.1e9 * 2048),
        ModelSpec("llama_tiny", llama.llama_tiny, vocab_size=1024,
                  causal_lm=True, is_text=True, input_shape=(64,),
                  flops_per_example=2 * 0.8e6 * 64),
        ModelSpec("gpt2", gpt.gpt2, vocab_size=gpt.GPT2_VOCAB,
                  causal_lm=True, is_text=True, input_shape=(gpt.GPT2_CTX,),
                  flops_per_example=2 * 124e6 * gpt.GPT2_CTX),
        ModelSpec("gpt2_medium", gpt.gpt2_medium, vocab_size=gpt.GPT2_VOCAB,
                  causal_lm=True, is_text=True, input_shape=(gpt.GPT2_CTX,),
                  flops_per_example=2 * 355e6 * gpt.GPT2_CTX),
        ModelSpec("gpt2_moe", gpt.gpt2_moe, vocab_size=gpt.GPT2_VOCAB,
                  causal_lm=True, is_text=True, input_shape=(gpt.GPT2_CTX,),
                  flops_per_example=2 * 180e6 * gpt.GPT2_CTX, moe=True),
        ModelSpec("moe_tiny", gpt.moe_tiny, vocab_size=1024,
                  causal_lm=True, is_text=True, input_shape=(64,),
                  flops_per_example=2 * 3e6 * 64, moe=True),
        # masked-LM encoders at the JAX registry's sequences and figures
        ModelSpec("bert_base", bert.bert_base_mlm,
                  vocab_size=bert.BERT_BASE_VOCAB, is_text=True,
                  input_shape=(128,), flops_per_example=2 * 110e6 * 128),
        ModelSpec("bert_large", bert.bert_large_mlm,
                  vocab_size=bert.BERT_BASE_VOCAB, is_text=True,
                  input_shape=(128,), flops_per_example=2 * 335e6 * 128),
        ModelSpec("bert_tiny", bert.bert_tiny_mlm, vocab_size=1024,
                  is_text=True, input_shape=(64,),
                  flops_per_example=2 * 4.5e6 * 64),
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
                 space_to_depth: bool = False, seq_len: int | None = None,
                 rank: int = 0, gradient_checkpointing: bool = False,
                 scan_layers: bool = False, moe_impl: str = "einsum",
                 moe_capacity_factor: float = 1.25, moe_f_chunk: int = 0):
    """``(model, spec)``: the model built on ``device`` with its weights
    drawn from a ``torch.Generator`` seeded with ``seed`` (on the same
    device, so a full-width model never passes through host memory), in
    training mode when ``train``.  Models keep float32 parameters and
    compute in ``dtype`` (float32 or bfloat16); image models live in
    ``channels_last`` memory.  Every data-parallel rank draws the same
    weights; a text model's dropout draws from its own generator, seeded
    with ``dropout_seed(seed, rank)``.  A scanned decoder
    (``scan_layers``) holds the unrolled one's weights for the same
    seed."""
    spec = get_model_spec(name)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"models compute in float32|bfloat16: {dtype}")
    if spec.moe:
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"--moe_impl must be one of {MOE_IMPLS} "
                             f"here: {moe_impl!r}")
        moe_kw = dict(moe_impl=moe_impl,
                      moe_capacity_factor=moe_capacity_factor,
                      moe_f_chunk=moe_f_chunk)
    else:
        moe_kw = {}
        if moe_impl != "einsum":
            raise ValueError(f"--moe_impl only applies to MoE members, "
                             f"not {name}")
        if moe_capacity_factor != 1.25:
            raise ValueError(f"--moe_capacity_factor only applies to MoE "
                             f"members, not {name}")
        if moe_f_chunk:
            raise ValueError(f"--moe_f_chunk only applies to MoE members, "
                             f"not {name}")
    if scan_layers and not spec.causal_lm:    # the decoder families
        raise ValueError(f"--scan_layers is not supported for {name} "
                         "(decoder families only: gpt2*/moe*/llama*)")
    if spec.is_text:
        if fused_conv or space_to_depth:
            raise ValueError(f"--fused_conv and --use_space_to_depth "
                             f"apply to the resnets, not {name}")
        if seq_len is not None:
            spec = dataclasses.replace(
                spec, input_shape=(seq_len,),
                flops_per_example=spec.flops_per_example
                * seq_len / spec.input_shape[0])
        extra = dict(moe_kw)
        if gradient_checkpointing:
            extra["remat"] = True
        if scan_layers:
            extra["scan_layers"] = True
        factory = lambda: spec.create(                      # noqa: E731
            dtype=dtype, attention_impl=attention_impl, max_len=seq_len,
            **extra)
    else:
        if attention_impl != "dense" or seq_len is not None:
            raise ValueError(f"--attention_impl and --seq_len apply to "
                             f"text models, not {name}")
        if gradient_checkpointing:
            raise ValueError("--gradient_checkpointing currently applies "
                             f"to transformer members only, not {name}")
        factory = lambda: spec.create(                      # noqa: E731
            num_classes=num_classes or spec.num_classes, dtype=dtype,
            space_to_depth=space_to_depth, fused_conv=fused_conv)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = factory()
    model = model.to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.init_weights(gen)
    if spec.is_text:
        model.dropout_generator = torch.Generator(device=dev)
        model.dropout_generator.manual_seed(dropout_seed(seed, rank))
    if not spec.is_text:
        model = model.to(memory_format=torch.channels_last)
    return model.train(train), spec
