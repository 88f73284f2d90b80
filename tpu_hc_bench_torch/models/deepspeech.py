"""DeepSpeech2, tf_cnn_benchmarks' speech member: the port of the JAX
package's ``models/deepspeech.py``.

A strided conv frontend over the ``[time, freq]`` spectrogram (41x11 at
stride (2, 2), then 21x11 at stride (2, 1), SAME, each with BatchNorm
and the DS2 clipped relu ``min(relu(x), 20)``), the map flattened in
Flax's ``[B, T, F, C]`` order (C fastest) to ``[B, T, F * C]``, five
bidirectional GRU layers with sum-merged directions, each followed by a
BatchNorm over (batch, time) per feature, and a float32 CTC head over
the 29-character alphabet (blank 0).

The GRU is Flax's ``GRUCell``: gate order ``[r | z | n]``, ``r`` and
``z`` sigmoids of the summed input and hidden products (no hidden bias),
``n = tanh(x_n + r * (h W_hn + b_hn))`` and ``h' = (1 - z) * n + z *
h``.  One parameter layout serves the JAX package's three
``--rnn_impl`` arms (``BiGRU``: per direction an ``input_gates`` Dense
``[3H, I]``, ``hidden_gates [H, 3H]`` in Flax's orientation and
``candidate_bias [H]``), so one ``state_dict`` loads into any arm:

- ``hoisted`` (JAX's ``HoistedGRU`` pair): the input products of the whole
  utterance in one product a direction, then a loop over frames with
  the ``[B, H] x [H, 3H]`` hidden product; the reverse direction runs
  ``t = T-1 .. 0`` and writes its outputs back in frame order; the carry
  stays in the compute dtype, as the JAX scan's;
- ``bidi`` (JAX's ``BiHoistedGRU``): both directions in one loop, the carry
  ``[2, B, H]`` against the stacked ``[2, H, 3H]`` hidden gates;
- ``flax`` (``nn.RNN(GRUCell)`` in ``nn.Bidirectional``): all six gate
  products inside the step, the carry in float32 (Flax's
  ``initialize_carry`` makes it in ``param_dtype``, and ``z * h``
  promotes it back each step).

The recurrence is an eager loop: at full width 75 frames a direction
and layer, each step a few launches, so the host's dispatch bounds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_hc_bench_torch.models.bert import Dense
from tpu_hc_bench_torch.models.resnet import BatchNorm, Conv, FlaxInit

# 26 letters + space + apostrophe + CTC blank (id 0)
DS2_VOCAB = 29
DS2_FREQ = 161                 # spectrogram bins
DS2_FRAMES = 300               # synthetic utterance length (frames)
DS2_MAX_LABEL = 50             # synthetic transcript length bound
DS2_TIME_STRIDE = 4            # the conv frontend's time downsampling
RELU_CLIP = 20.0
RNN_IMPLS = ("hoisted", "bidi", "flax")


def max_label_for(frames: int) -> int:
    """Largest CTC-feasible transcript length for an utterance of
    ``frames``: the post-conv frame count less a margin for repeated
    characters (each repeat needs a blank frame between)."""
    return min(DS2_MAX_LABEL, frames // DS2_TIME_STRIDE - 4)


def _gru_scan(xg: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """The hoisted recurrence over time-major gate inputs ``xg [T, ...,
    B, 3H]`` with ``wh [..., H, 3H]`` and ``bn [..., 1, H]``, from a zero
    carry in ``xg``'s dtype; the outputs ``[T, ..., B, H]`` in frame
    order."""
    h = wh.shape[-2]
    carry = xg.new_zeros(xg.shape[1:-1] + (h,))
    out: list = [None] * xg.shape[0]
    steps = range(xg.shape[0] - 1, -1, -1) if reverse \
        else range(xg.shape[0])
    for t in steps:
        hg = torch.matmul(carry, wh)
        x_t = xg[t]
        rz = torch.sigmoid(x_t[..., :2 * h] + hg[..., :2 * h])
        r, z = rz[..., :h], rz[..., h:]
        n = torch.tanh(x_t[..., 2 * h:] + r * (hg[..., 2 * h:] + bn))
        carry = (1.0 - z) * n + z * carry
        out[t] = carry
    return torch.stack(out)


class HoistedGRU(nn.Module):
    """One direction of a GRU layer: ``input_gates`` (Flax ``Dense(3H)``
    with its bias, the input products of every frame at once),
    ``hidden_gates [H, 3H]`` and ``candidate_bias [H]``."""

    def __init__(self, cin: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.input_gates = Dense(cin, 3 * hidden, dtype)
        self.hidden_gates = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.candidate_bias = nn.Parameter(torch.empty(hidden))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        self.input_gates.init_weights(gen)
        nn.init.orthogonal_(self.hidden_gates, generator=gen)
        self.candidate_bias.zero_()

    def recurrent(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(hidden_gates, candidate_bias)`` in the compute dtype."""
        return (self.hidden_gates.to(self.dtype),
                self.candidate_bias.to(self.dtype))

    def forward(self, x: torch.Tensor, reverse: bool = False
                ) -> torch.Tensor:
        """``[B, T, I]`` to ``[B, T, H]``."""
        wh, bn = self.recurrent()
        xg = self.input_gates(x).transpose(0, 1)
        return _gru_scan(xg, wh, bn, reverse).transpose(0, 1)

    def flax_cell_forward(self, x: torch.Tensor,
                          reverse: bool = False) -> torch.Tensor:
        """Flax's ``GRUCell`` under ``nn.RNN``: the six gate products of
        ``ir, iz, in`` (with biases) and ``hr, hz, hn`` (``hn`` with the
        candidate bias) inside each step, the carry in float32."""
        hidden = self.hidden_gates.shape[0]
        w_i = self.input_gates.weight.to(self.dtype)
        b_i = self.input_gates.bias.to(self.dtype)
        wh, bn = self.recurrent()
        gates = [(w_i[k * hidden:(k + 1) * hidden],
                  b_i[k * hidden:(k + 1) * hidden],
                  wh[:, k * hidden:(k + 1) * hidden]) for k in range(3)]
        x = x.to(self.dtype)
        h = x.new_zeros((x.shape[0], hidden), dtype=torch.float32)
        out: list = [None] * x.shape[1]
        steps = range(x.shape[1] - 1, -1, -1) if reverse \
            else range(x.shape[1])
        for t in steps:
            x_t, hc = x[:, t], h.to(self.dtype)
            (wir, bir, whr), (wiz, biz, whz), (win, bin_, whn) = gates
            r = torch.sigmoid(F.linear(x_t, wir) + bir + hc @ whr)
            z = torch.sigmoid(F.linear(x_t, wiz) + biz + hc @ whz)
            n = torch.tanh(F.linear(x_t, win) + bin_ + r * (hc @ whn + bn))
            h = (1.0 - z) * n + z * h
            out[t] = h
        return torch.stack(out, 1)


class BiGRU(nn.Module):
    """A sum-merged bidirectional GRU layer, ``fwd`` and ``bwd``, run by
    ``rnn_impl``'s arm."""

    def __init__(self, cin: int, hidden: int, rnn_impl: str = "hoisted",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if rnn_impl not in RNN_IMPLS:
            raise ValueError(f"unknown rnn_impl {rnn_impl!r}")
        self.rnn_impl = rnn_impl
        self.fwd = HoistedGRU(cin, hidden, dtype)
        self.bwd = HoistedGRU(cin, hidden, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rnn_impl == "hoisted":
            return self.fwd(x) + self.bwd(x, reverse=True)
        if self.rnn_impl == "flax":
            return (self.fwd.flax_cell_forward(x)
                    + self.bwd.flax_cell_forward(x, reverse=True))
        # bidi: at loop index j the forward direction takes frame j and
        # the backward direction frame T-1-j
        (wf, bf), (wb, bb) = self.fwd.recurrent(), self.bwd.recurrent()
        xs = torch.stack([self.fwd.input_gates(x).transpose(0, 1),
                          self.bwd.input_gates(x).flip(1).transpose(0, 1)],
                         1)                                # [T, 2, B, 3H]
        ys = _gru_scan(xs, torch.stack([wf, wb]),
                       torch.stack([bf, bb])[:, None, :])  # [T, 2, B, H]
        return (ys[:, 0] + ys.flip(0)[:, 1]).transpose(0, 1)


class DeepSpeech2(FlaxInit):
    """``[B, T, F]`` spectrograms to float32 ``[B, T', vocab]`` logits
    (``T' = ceil(T / 4)``)."""

    def __init__(self, vocab_size: int = DS2_VOCAB, rnn_hidden: int = 800,
                 num_rnn_layers: int = 5, conv_channels: int = 32,
                 dtype: torch.dtype = torch.float32,
                 rnn_impl: str = "hoisted", freq: int = DS2_FREQ):
        super().__init__()
        self.dtype, self.rnn_impl = dtype, rnn_impl
        c = conv_channels
        self.conv1 = Conv(1, c, (41, 11), (2, 2), dtype)
        self.conv1_bn = BatchNorm(c, dtype)
        self.conv2 = Conv(c, c, (21, 11), (2, 1), dtype)
        self.conv2_bn = BatchNorm(c, dtype)
        cin = -(-freq // 2) * c
        grus, bns = [], []
        for _ in range(num_rnn_layers):
            grus.append(BiGRU(cin, rnn_hidden, rnn_impl, dtype))
            bns.append(BatchNorm(rnn_hidden, dtype))
            cin = rnn_hidden
        self.grus, self.rnn_bns = nn.ModuleList(grus), nn.ModuleList(bns)
        self.ctc_head = nn.Linear(rnn_hidden, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).unsqueeze(1)          # NCHW [B, 1, T, F]
        for conv, bn in ((self.conv1, self.conv1_bn),
                         (self.conv2, self.conv2_bn)):
            x = torch.clamp_max(torch.relu(bn(conv(x))), RELU_CLIP)
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        for gru, bn in zip(self.grus, self.rnn_bns):
            # BatchNorm over (batch, time) per feature, as over NCHW's
            # (N, H, W) per channel
            y = gru(x).transpose(1, 2).unsqueeze(-1)
            x = bn(y).squeeze(-1).transpose(1, 2)
        return self.ctc_head(x.float())


def deepspeech2(num_classes: int = DS2_VOCAB,
                dtype: torch.dtype = torch.float32,
                rnn_impl: str = "hoisted") -> DeepSpeech2:
    """DS2 at the paper's shape: 5 x 800 summed BiGRU, ~48M params."""
    del num_classes
    return DeepSpeech2(dtype=dtype, rnn_impl=rnn_impl)


def deepspeech2_tiny(num_classes: int = DS2_VOCAB,
                     dtype: torch.dtype = torch.float32,
                     rnn_impl: str = "hoisted") -> DeepSpeech2:
    """2 x 32 BiGRU over 32 frequency bins, for tests and CPU smoke
    runs."""
    del num_classes
    return DeepSpeech2(rnn_hidden=32, num_rnn_layers=2, conv_channels=4,
                       dtype=dtype, rnn_impl=rnn_impl, freq=32)
