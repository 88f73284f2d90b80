"""Neural Collaborative Filtering (NeuMF), tf_cnn_benchmarks' ``ncf``: the
port of the JAX package's ``models/ncf.py``.

``[B, 2]`` (user, item) id pairs through a GMF tower (the product of a
user and an item embedding) and an MLP tower (the concatenated user and
item embeddings through 256 -> 256 -> 128 -> 64 relu Dense layers in
the compute dtype), fused into a float32 2-way head: binary implicit
feedback as a softmax over two classes, so the image arm's loss and
top-1 (binary accuracy) apply unchanged.  The four tables are the
MovieLens ml-20m cardinalities.  Flax's ``Embed`` casts its table to
the compute dtype before the gather; here each row is gathered, then
cast: the same values.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.models.bert import Dense
from tpu_hc_bench_torch.models.resnet import FlaxInit, lecun_normal_

# MovieLens ml-20m cardinalities (the MLPerf NCF dataset)
ML20M_USERS = 138_493
ML20M_ITEMS = 26_744


class Embed(nn.Module):
    """Flax ``nn.Embed``: a float32 ``[num, features]`` table, drawn as
    Flax's default (variance scaling over ``features``, truncated
    normal), rows returned in ``dtype``."""

    def __init__(self, num: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features))

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            lecun_normal_(self.weight, self.weight.shape[1], gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


class NeuMF(FlaxInit):
    def __init__(self, num_users: int = ML20M_USERS,
                 num_items: int = ML20M_ITEMS, mf_dim: int = 64,
                 mlp_dims: Sequence[int] = (256, 256, 128, 64),
                 num_classes: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_users, self.num_items = num_users, num_items
        self.mf_user = Embed(num_users, mf_dim, dtype)
        self.mf_item = Embed(num_items, mf_dim, dtype)
        half = mlp_dims[0] // 2
        self.mlp_user = Embed(num_users, half, dtype)
        self.mlp_item = Embed(num_items, half, dtype)
        self.mlp = nn.ModuleList(Dense(a, b, dtype) for a, b in
                                 zip(mlp_dims[:-1], mlp_dims[1:]))
        self.head = nn.Linear(mf_dim + mlp_dims[-1], num_classes)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        users, items = ids[:, 0], ids[:, 1]
        gmf = self.mf_user(users) * self.mf_item(items)
        x = torch.cat([self.mlp_user(users), self.mlp_item(items)], -1)
        for dense in self.mlp:
            x = torch.relu(dense(x))
        return self.head(torch.cat([gmf, x], -1).float())


def ncf(num_classes: int = 2, dtype: torch.dtype = torch.float32) -> NeuMF:
    """NeuMF at the MLPerf ml-20m shape, ~31.8M parameters (the
    embeddings: (138493 + 26744) x (64 + 128)); two classes always."""
    del num_classes
    return NeuMF(dtype=dtype)


def ncf_tiny(num_classes: int = 2,
             dtype: torch.dtype = torch.float32) -> NeuMF:
    """A small-vocabulary NeuMF for tests and CPU smoke runs."""
    del num_classes
    return NeuMF(num_users=1000, num_items=500, mf_dim=8,
                 mlp_dims=(32, 32, 16, 8), dtype=dtype)
