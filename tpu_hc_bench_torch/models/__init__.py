"""Model registry of the port: the ``--model=`` dispatch, the JAX
registry's members (tf_cnn_benchmarks' zoo and the transformer
families) and its aliases.

Ported: every image member (``trivial``, alexnet, googlenet, lenet,
overfeat, mobilenet, nasnet/nasnetlarge, the densenets, the resnets v1,
v2 and CIFAR, the vggs, the ViTs, inception3/4), the text members
(``gpt2``, ``gpt2_medium``, ``gpt2_moe``, ``moe_tiny``, ``llama_1b``,
``llama_tiny``, ``bert_base``, ``bert_large``, ``bert_tiny``), the
speech member (``deepspeech2``, ``deepspeech2_tiny``: ``ctc``, spectrogram
input and the CTC loss) and the recommendation member (``ncf``,
``ncf_tiny``: ``integer_input``, id pairs); every member of the JAX
registry.  The serving lane serves every ``causal_lm`` member by decode
and the image and speech members by classify.

``get_model_spec`` and ``create_model`` keep the JAX package's names and
return values (``create_model`` returns ``(model, spec)``); the port's
``create_model`` also places the model on its device and initialises
its weights from ``seed``.  ``flops_per_example`` is the forward FLOP
count at ``input_shape`` (2 x multiply-adds), the JAX registry's figure,
used for MFU (a train step is ~3x the forward); a text model's
``seq_len`` override rescales it linearly and grows the position table,
as the JAX ``create_model`` does.  The guards are the JAX
``create_model``'s: ``attention_impl`` and ``gradient_checkpointing``
reach the transformers (text members and the ``attention`` members, the
ViTs; the other image members ignore ``attention_impl``, as in JAX, and
refuse ``gradient_checkpointing``), ``space_to_depth`` the
``supports_s2d`` members (the ImageNet resnets), ``fused_conv`` the v1
bottleneck resnets, ``scan_layers`` the decoder families, the MoE
knobs the MoE members and ``rnn_impl`` the RNN (CTC) members.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from tpu_hc_bench_torch import resolve_device
from tpu_hc_bench_torch.models import (
    alexnet, bert, cifar_resnet, deepspeech, densenet, googlenet, gpt,
    inception, llama, mobilenet, nasnet, ncf, resnet, small_cnns, vgg, vit)
from tpu_hc_bench_torch.models.moe import MOE_IMPLS


# a model's dropout stream is seeded apart from its weights' stream
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


class TrivialModel(resnet.FlaxInit):
    """tf_cnn_benchmarks' ``trivial``: the image flattened in Flax's NHWC
    order, then one float32 dense layer."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, image_size: int = 224):
        super().__init__()
        self.dtype = dtype
        self.head = nn.Linear(image_size * image_size * 3, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(resnet.flatten_nhwc(x.to(self.dtype)).float())


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
    supports_s2d: bool = False         # factory takes space_to_depth
    attention: bool = False            # image transformer (ViT): factory
                                       # takes attention_impl and remat
    ctc: bool = False                  # spectrogram input, CTC loss;
                                       # factory takes rnn_impl
    integer_input: bool = False        # [B, 2] int id pairs


def _image(name: str, create, flops: float, size: int = 224,
           **kw) -> ModelSpec:
    return ModelSpec(name, create, input_shape=(size, size, 3),
                     num_classes=1000, flops_per_example=flops, **kw)


def _registry() -> dict[str, ModelSpec]:
    s2d = dict(supports_s2d=True)
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
        # the image zoo at the JAX registry's sizes and forward FLOPs
        # (2 x MACs of the conv and dense layers)
        _image("trivial", TrivialModel, 2 * 150528 * 1000),
        _image("alexnet", alexnet.alexnet, 1.43e9),
        _image("googlenet", googlenet.googlenet, 3.0e9),
        _image("lenet", small_cnns.lenet, 2.46e7, 28),
        _image("overfeat", small_cnns.overfeat, 7.53e9, 231),
        _image("mobilenet", mobilenet.mobilenet, 1.16e9),
        _image("nasnet", nasnet.nasnet, 1.13e9),
        _image("nasnetlarge", nasnet.nasnetlarge, 4.76e10, 331),
        _image("densenet40_k12", densenet.densenet40_k12, 5.08e8, 32),
        _image("densenet100_k12", densenet.densenet100_k12, 1.88e9, 32),
        # ResNet v1.5 (and v2: the same conv stack) at 224^2
        _image("resnet18", resnet.resnet18, 3.64e9, **s2d),
        _image("resnet34", resnet.resnet34, 7.34e9, **s2d),
        _image("resnet50", resnet.resnet50, 8.2e9, fused_conv=True, **s2d),
        _image("resnet101", resnet.resnet101, 15.7e9, fused_conv=True,
               **s2d),
        _image("resnet152", resnet.resnet152, 23.1e9, fused_conv=True,
               **s2d),
        _image("resnet50_v2", resnet.resnet50_v2, 8.2e9, **s2d),
        _image("resnet101_v2", resnet.resnet101_v2, 15.7e9, **s2d),
        _image("resnet152_v2", resnet.resnet152_v2, 23.1e9, **s2d),
        _image("resnet20_cifar", cifar_resnet.resnet20_cifar, 8.2e7, 32),
        _image("resnet32_cifar", cifar_resnet.resnet32_cifar, 1.4e8, 32),
        _image("resnet44_cifar", cifar_resnet.resnet44_cifar, 1.9e8, 32),
        _image("resnet56_cifar", cifar_resnet.resnet56_cifar, 2.5e8, 32),
        _image("resnet110_cifar", cifar_resnet.resnet110_cifar, 5.1e8, 32),
        _image("vgg11", vgg.vgg11, 15.2e9),
        _image("vgg16", vgg.vgg16, 30.9e9),
        _image("vgg19", vgg.vgg19, 39.3e9),
        _image("vit_b16", vit.vit_b16, 35.2e9, attention=True),
        _image("vit_l16", vit.vit_l16, 123.2e9, attention=True),
        _image("vit_tiny", vit.vit_tiny, 5.3e6, 32, attention=True),
        _image("inception3", inception.inception_v3, 11.4e9, 299),
        _image("inception4", inception.inception_v4, 24.5e9, 299),
        # speech: 2 strided convs + 5 x 800 summed BiGRU + CTC, forward
        # FLOPs ~= 2 x MACs at [300, 161] frames
        ModelSpec("deepspeech2", deepspeech.deepspeech2,
                  input_shape=(300, 161), flops_per_example=1.0e10,
                  ctc=True),
        ModelSpec("deepspeech2_tiny", deepspeech.deepspeech2_tiny,
                  input_shape=(64, 32), flops_per_example=2.0e7, ctc=True),
        # NeuMF at ml-20m: 2 x MACs of the MLP tower and head (the
        # embedding gathers are bytes, not MACs)
        ModelSpec("ncf", ncf.ncf, input_shape=(2,), flops_per_example=2.8e5,
                  integer_input=True),
        ModelSpec("ncf_tiny", ncf.ncf_tiny, input_shape=(2,),
                  flops_per_example=5.0e3, integer_input=True),
    ]
    return {s.name: s for s in specs}

_ALIASES = {
    "resnet50_v1.5": "resnet50",
    "inception_v3": "inception3",
    "bert": "bert_base",
    "bert-base": "bert_base",
    "lenet5": "lenet",
    "densenet": "densenet40_k12",
    "mobilenet_v1": "mobilenet",
    "inception_v4": "inception4",
    # tf_cnn_benchmarks names the CIFAR family bare resnet<depth>
    "resnet20": "resnet20_cifar",
    "resnet32": "resnet32_cifar",
    "resnet44": "resnet44_cifar",
    "resnet56": "resnet56_cifar",
    "resnet110": "resnet110_cifar",
}


def get_model_spec(name: str) -> ModelSpec:
    reg = _registry()
    key = _ALIASES.get(name.lower(), name.lower())
    if key not in reg:
        raise ValueError(f"unknown model {name!r}; have {sorted(reg)}")
    return reg[key]


def list_models() -> list[str]:
    return sorted(_registry())


def create_model(name: str, dtype=torch.float32,
                 attention_impl: str = "dense", *,
                 device: str | torch.device = "cuda", seed: int = 0,
                 fused_conv: bool = False, train: bool = False,
                 num_classes: int | None = None,
                 space_to_depth: bool = False, seq_len: int | None = None,
                 rank: int = 0, gradient_checkpointing: bool = False,
                 scan_layers: bool = False, moe_impl: str = "einsum",
                 moe_capacity_factor: float = 1.25, moe_f_chunk: int = 0,
                 rnn_impl: str = "hoisted", seq_axis=None,
                 pipeline: tuple[int, int] | None = None):
    """``(model, spec)``: the model built on ``device`` with its weights
    drawn from a ``torch.Generator`` seeded with ``seed`` (on the same
    device, so a full-width model never passes through host memory), in
    training mode when ``train``.  Models keep float32 parameters and
    compute in ``dtype`` (float32 or bfloat16); image models live in
    ``channels_last`` memory.  Every data-parallel rank draws the same
    weights; a model with dropout (a text model, a ViT, alexnet, vgg,
    googlenet, overfeat, inception3/4, nasnet) draws its masks from its
    own generator, seeded with ``dropout_seed(seed, rank)``.  Image
    models take ``num_classes`` classes (the registry's 1000 when None,
    CIFAR members too, as JAX's driver passes ``--num_classes``).  A
    scanned decoder (``scan_layers``) holds the unrolled one's weights
    for the same seed; an RNN member runs ``rnn_impl``'s arm
    (``hoisted|bidi|flax``), every arm on the same weights.  A text
    model takes ``seq_axis``, the seq group its sequence is sharded over
    (``models.bert``); the other members refuse it.  ``pipeline`` =
    ``(stages, stage)`` builds only that pipeline stage's layers of a
    decoder (``parallel.pipeline.cut_stage``; JAX's error where the
    stages do not divide the layers), each drawn as the whole model
    draws it."""
    spec = get_model_spec(name)
    if spec.ctc:
        if rnn_impl not in deepspeech.RNN_IMPLS:
            raise ValueError(f"unknown rnn_impl {rnn_impl!r}")
    elif rnn_impl != "hoisted":
        raise ValueError(f"--rnn_impl only applies to RNN members, not "
                         f"{name}")
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
    if space_to_depth and not spec.supports_s2d:
        raise ValueError(f"--use_space_to_depth: {name} has no s2d stem")
    if fused_conv and not spec.fused_conv:
        raise ValueError(f"--fused_conv applies to the v1 bottleneck "
                         f"resnets, not {name}")
    if gradient_checkpointing and not (spec.is_text or spec.attention):
        raise ValueError("--gradient_checkpointing currently applies to "
                         f"transformer members only, not {name}")
    if seq_len is not None and not spec.is_text:
        raise ValueError(f"--seq_len only applies to text models, not "
                         f"{name}")
    if seq_axis is not None and not spec.is_text:
        raise ValueError(f"--sequence_parallel only applies to text "
                         f"models, not {name}")
    kw: dict = dict(moe_kw, dtype=dtype)
    if spec.is_text or spec.attention:      # the transformers
        kw["attention_impl"] = attention_impl
        if gradient_checkpointing:
            kw["remat"] = True
    if scan_layers:
        kw["scan_layers"] = True
    if spec.ctc:
        kw["rnn_impl"] = rnn_impl
    if spec.is_text:
        if seq_len is not None:
            spec = dataclasses.replace(
                spec, input_shape=(seq_len,),
                flops_per_example=spec.flops_per_example
                * seq_len / spec.input_shape[0])
        kw["max_len"] = seq_len
        if seq_axis is not None:
            kw["seq_axis"] = seq_axis
    else:
        kw["num_classes"] = num_classes or spec.num_classes
    if spec.supports_s2d:
        kw["space_to_depth"] = space_to_depth
    if spec.fused_conv:
        kw["fused_conv"] = fused_conv
    dev = resolve_device(device)
    with torch.device("meta"):
        model = spec.create(**kw)
    if pipeline is not None:
        from tpu_hc_bench_torch.parallel.pipeline import cut_stage

        if not spec.causal_lm:
            raise ValueError(
                "--pipeline_parallel requires a decoder implementing the "
                "PP interface (pp_embed/pp_layer_module/pp_head: the GPT "
                f"and llama families), not {name}")
        if model.num_layers % pipeline[0]:
            raise ValueError(
                f"{name}: {model.num_layers} layers not divisible by "
                f"pipeline_parallel={pipeline[0]}")
        with torch.device("meta"):
            model = spec.create(**kw, layer_range=cut_stage(
                model.num_layers, *pipeline))
    model = model.to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.init_weights(gen)
    if hasattr(model, "dropout_generator"):
        model.dropout_generator = torch.Generator(device=dev)
        model.dropout_generator.manual_seed(dropout_seed(seed, rank))
    if not spec.is_text:
        model = model.to(memory_format=torch.channels_last)
    return model.train(train), spec
