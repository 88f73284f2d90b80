"""Per-card peak FLOP/s for MFU accounting, for the port's own devices.

Published dense peaks (NVIDIA's data sheets, SXM parts, no sparsity):
989 TFLOP/s for bf16 on the tensor cores and 67 TFLOP/s for float32
outside them (the port switches TF32 off, so float32 work runs there).
A card missing from the table, and the CPU, have no peak: ``peak_flops``
returns None and the caller reports MFU as unknown.
"""

from __future__ import annotations

import torch

# name fragment -> (bf16 peak, float32 peak); the PCIe and NVL parts run
# at other clocks and power and are left out rather than guessed
_PEAKS: dict[str, tuple[float, float]] = {
    "H100 80GB HBM3": (989e12, 67e12),      # H100 SXM
    "H100 SXM": (989e12, 67e12),
}


def device_name(device: str | torch.device = "cuda") -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def peak_flops(dtype: str = "bfloat16",
               device: str | torch.device = "cuda") -> float | None:
    """Peak FLOP/s of one card for ``dtype`` (``bfloat16`` or
    ``float32``), or None where the card is not in the table."""
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be bfloat16|float32: {dtype!r}")
    if torch.device(device).type != "cuda":
        return None
    name = device_name(device)
    for key, (bf16, f32) in _PEAKS.items():
        if key in name:
            return bf16 if dtype == "bfloat16" else f32
    return None
