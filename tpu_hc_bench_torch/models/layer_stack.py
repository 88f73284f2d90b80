"""Rematerialised and scanned transformer layers, shared by the port's
transformer families (``--gradient_checkpointing``, ``--scan_layers``).

- ``remat(fn, generator, *args)``: ``fn(*args)`` under
  ``torch.utils.checkpoint`` (``use_reentrant=False``), Flax's
  ``nn.remat``: the layer's activations are dropped after the forward
  and recomputed in the backward.  The layers draw dropout from an
  explicit ``torch.Generator``, which the checkpoint's
  ``preserve_rng_state`` does not cover (it saves the global CPU and
  CUDA generators only), so ``remat`` takes the generator's state
  before the forward and hands it to the recompute, then puts back the
  state the recompute found: the recompute draws the forward's masks
  and the stream goes on where the forward left it.
- ``--scan_layers`` (Flax's ``nn.scan`` over the trunk): one layer body
  whose every parameter is stacked ``[L, ...]`` (``stack_parameters_``),
  the JAX ``layers/...`` layout, applied to its slice ``i`` through
  ``torch.func.functional_call`` (``call_layer`` over ``layer_slices``);
  the gradients land in the stacked ``.grad``.  ``init_stacked_`` draws
  slice ``i`` as the unrolled model draws layer ``i`` (one fresh layer
  at a time, in order), so a scanned model holds the unrolled model's
  weights for the same seed; ``stack_state_dict`` and
  ``unstack_state_dict`` move a ``state_dict`` between the two layouts.
"""

from __future__ import annotations

import re
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def remat(fn: Callable, generator: torch.Generator | None, *args):
    """``fn(*args)``, its activations recomputed in the backward with
    the dropout masks of the forward."""
    state = generator.get_state() if generator is not None else None
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1 or generator is None:
            return fn(*a)
        now = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*a)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def stack_parameters_(body: nn.Module, num_layers: int) -> nn.Module:
    """Replace every parameter of ``body`` by an empty ``[num_layers,
    *shape]`` one, in place; returns ``body``."""
    for name, p in list(body.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = body.get_submodule(owner_name) if owner_name else body
        setattr(owner, leaf, nn.Parameter(
            p.new_empty((num_layers, *p.shape))))
    return body


def layer_slices(body: nn.Module) -> list[dict[str, torch.Tensor]]:
    """Every layer's parameters, as views of the stacked ones: one
    ``unbind`` a parameter a forward, whose backward stacks the L slice
    gradients in one write (a ``p[i]`` a layer would write a full
    ``[L, ...]`` gradient for each of the L slices)."""
    names = [name for name, _ in body.named_parameters()]
    per = [p.unbind(0) for _, p in body.named_parameters()]
    return [dict(zip(names, vals)) for vals in zip(*per)]


def call_layer(body: nn.Module, params: dict[str, torch.Tensor], *args,
               **kwargs):
    """The stacked ``body`` applied with one layer's ``params``."""
    return torch.func.functional_call(body, params, args, kwargs)


@torch.no_grad()
def init_layers_(layers: nn.ModuleList, make_layer: Callable[[], nn.Module],
                 num_layers: int, layer_range: tuple[int, int],
                 generator: torch.Generator) -> None:
    """Layers ``[lo, hi)`` of a ``num_layers`` trunk, held in ``layers``
    (a pipeline stage's; all of them by default), drawn as the whole
    trunk draws them: a layer outside the range is drawn into a
    throwaway ``make_layer()`` on the layers' device, one at a time."""
    lo, hi = layer_range
    dev = next(layers.parameters()).device if len(layers) else None
    for i in range(num_layers):
        if lo <= i < hi:
            layers[i - lo].init_weights(generator)
            continue
        with torch.device(dev or generator.device):
            make_layer().init_weights(generator)


@torch.no_grad()
def init_stacked_(body: nn.Module, make_layer: Callable[[], nn.Module],
                  num_layers: int, generator: torch.Generator) -> None:
    """Slice ``i`` of every stacked parameter drawn as the unrolled
    model draws layer ``i``: a fresh ``make_layer()`` on the parameters'
    device, its ``init_weights(generator)``, copied in."""
    dev = next(body.parameters()).device
    for i in range(num_layers):
        with torch.device(dev):
            layer = make_layer()
        layer.init_weights(generator)
        for name, p in layer.named_parameters():
            body.get_parameter(name)[i].copy_(p)


_LAYER_KEY = re.compile(r"layers\.(\d+)\.(.+)")


def stack_state_dict(sd: dict, num_layers: int) -> dict:
    """An unrolled ``state_dict`` (``layers.<i>.<name>``) in the stacked
    layout (``layers.<name>`` of ``[L, ...]``)."""
    out, per = {}, {}
    for k, v in sd.items():
        m = _LAYER_KEY.fullmatch(k)
        if m:
            per.setdefault(m.group(2), {})[int(m.group(1))] = v
        else:
            out[k] = v
    for name, slices in per.items():
        if sorted(slices) != list(range(num_layers)):
            raise ValueError(f"layers of {name}: {sorted(slices)}, want "
                             f"0..{num_layers - 1}")
        out[f"layers.{name}"] = torch.stack([slices[i]
                                             for i in range(num_layers)])
    return out


def unstack_state_dict(sd: dict, stacked_names) -> dict:
    """A stacked ``state_dict`` in the unrolled layout; ``stacked_names``
    are the body's parameter names (``layers.<name>`` in ``sd``)."""
    out = {k: v for k, v in sd.items()
           if not (k.startswith("layers.")
                   and k[len("layers."):] in stacked_names)}
    for name in stacked_names:
        for i, t in enumerate(sd[f"layers.{name}"].unbind(0)):
            out[f"layers.{i}.{name}"] = t
    return out
