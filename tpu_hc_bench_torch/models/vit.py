"""Vision Transformers (vit_b16, vit_l16, vit_tiny): the port of the JAX
package's ``models/vit.py``.

A stride-``patch`` VALID conv with a bias patchifies the image; the
patches, in (h, w) order as Flax's NHWC reshape gives them, follow a
zero-initialised class token; a learned ``pos_embed`` (normal, 0.02)
is added and dropout 0.1 applied; the encoder is the GPT family's
pre-LN ``DecoderLayer`` with ``causal=False`` (the JAX model reuses
``gpt.DecoderLayer`` the same way), so ``--attention_impl=flash`` runs
the flash kernels over the ``(image_size / patch)^2 + 1`` tokens (197 at
224 px and patch 16); then ``ln_f`` and a float32 head on token 0.

The dtype policy is the GPT family's (``models/gpt.py``): float32
parameters, products in the compute ``dtype``, LayerNorm statistics in
float32.  Dropout draws from ``model.dropout_generator`` in the
embedding and twice a layer; ``remat`` (``--gradient_checkpointing``)
recomputes each layer in the backward with the forward's masks
(``models.layer_stack.remat``).  ``pos_embed`` is sized at construction
from ``image_size`` (the JAX module sizes it at ``init`` from the input).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from tpu_hc_bench_torch.models import layer_stack
from tpu_hc_bench_torch.models.bert import LayerNorm, dropout
from tpu_hc_bench_torch.models.gpt import DecoderLayer
from tpu_hc_bench_torch.models.resnet import Conv, lecun_normal_

EMBED_DROPOUT = 0.1
POS_EMBED_STD = 0.02


class ViT(nn.Module):
    """Patchify conv -> class token + position embedding -> pre-LN
    encoder -> LayerNorm -> head on the class token; NCHW images in,
    float32 logits out."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 hidden: int = 768, num_layers: int = 12, heads: int = 12,
                 ffn: int = 3072, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", remat: bool = False,
                 image_size: int = 224):
        super().__init__()
        self.hidden, self.num_layers, self.dtype = hidden, num_layers, dtype
        self.remat = remat
        self.patchify = Conv(3, hidden, patch, patch, dtype, padding="VALID",
                             bias=True)
        self.cls = nn.Parameter(torch.empty(1, 1, hidden))
        tokens = (image_size // patch) ** 2 + 1
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, hidden))
        self.layers = nn.ModuleList(
            DecoderLayer(hidden, heads, ffn, dtype, attention_impl,
                         causal=False) for _ in range(num_layers))
        self.ln_f = LayerNorm(hidden, dtype)
        self.head = nn.Linear(hidden, num_classes)
        self.dropout_generator: torch.Generator | None = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's initialisers, drawn from ``generator`` in module order:
        lecun-normal kernels and zero biases, a zero class token, a
        normal(0.02) position table, unit LayerNorms."""
        self.patchify.init_weights(generator)
        self.cls.zero_()
        nn.init.normal_(self.pos_embed, 0.0, POS_EMBED_STD,
                        generator=generator)
        for layer in self.layers:
            layer.init_weights(generator)
        self.ln_f.init_weights()
        lecun_normal_(self.head.weight, self.hidden, generator)
        self.head.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.patchify(x.to(self.dtype))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.hidden)
        cls = self.cls.to(self.dtype).expand(b, 1, self.hidden)
        x = torch.cat([cls, x], dim=1)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(f"{x.shape[1]} tokens, but pos_embed holds "
                             f"{self.pos_embed.shape[1]}")
        x = x + self.pos_embed.to(self.dtype)
        gen = self.dropout_generator
        x = dropout(x, EMBED_DROPOUT, gen, self.training)
        for layer in self.layers:
            fn = functools.partial(layer, generator=gen)
            if self.remat and torch.is_grad_enabled():
                x = layer_stack.remat(fn, gen, x)
            else:
                x = fn(x)
        x = self.ln_f(x)
        return self.head(x[:, 0].float())


def vit_b16(num_classes: int = 1000, dtype: torch.dtype = torch.float32,
            attention_impl: str = "dense", remat: bool = False,
            image_size: int = 224) -> ViT:
    """ViT-Base/16 (12 layers, hidden 768, 12 heads; ~86M parameters)."""
    return ViT(num_classes=num_classes, dtype=dtype,
               attention_impl=attention_impl, remat=remat,
               image_size=image_size)


def vit_l16(num_classes: int = 1000, dtype: torch.dtype = torch.float32,
            attention_impl: str = "dense", remat: bool = False,
            image_size: int = 224) -> ViT:
    """ViT-Large/16 (24 layers, hidden 1024, 16 heads; ~304M)."""
    return ViT(num_classes=num_classes, hidden=1024, num_layers=24,
               heads=16, ffn=4096, dtype=dtype,
               attention_impl=attention_impl, remat=remat,
               image_size=image_size)


def vit_tiny(num_classes: int = 1000, dtype: torch.dtype = torch.float32,
             attention_impl: str = "dense", remat: bool = False,
             image_size: int = 32) -> ViT:
    """4 layers, hidden 64, patch 8, 32 px: tests and CPU smoke runs."""
    return ViT(num_classes=num_classes, patch=8, hidden=64, num_layers=4,
               heads=4, ffn=128, dtype=dtype, attention_impl=attention_impl,
               remat=remat, image_size=image_size)
