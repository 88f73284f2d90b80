"""Device memory for the serving lane: the ``--hbm_budget`` check, a
device-memory sample and the forensics dump (the port's counterpart of
the JAX package's ``obs/memory.py``, its serving part).

The JAX lane checks the budget against the AOT ``memory_analysis()`` of
the warmed ladder's worst bucket.  Eager PyTorch compiles nothing ahead
of time, so the port's measured report is the peak allocated over the
warmed ladder: the engine resets the allocator's peak, runs every
bucket once and reads ``torch.cuda.max_memory_allocated``
(``ladder_report``).  The peak holds the weights, the KV pool and the
largest bucket's temporaries: the same footprint the AOT total counts
(arguments, outputs and temporaries), measured instead of predicted.

On the CPU there is no allocator peak: no report, and the budget check
prints the JAX lane's "budget unchecked" warning instead of a made-up
number.  ``auto`` resolves to the card's total memory
(``torch.cuda.mem_get_info``).

``dump_forensics`` writes ``memory_dump.json`` beside the metrics
stream on the watchdog's path: the allocator's statistics and the live
tensors on the device, aggregated by (shape, dtype).  Best-effort by
construction: forensics on a dying run must never mask the death.
"""

from __future__ import annotations

import json
import os
import time

MEMORY_DUMP_NAME = "memory_dump.json"

_BUDGET_SUFFIXES = (
    ("tib", 2**40), ("gib", 2**30), ("mib", 2**20), ("kib", 2**10),
    ("tb", 2**40), ("gb", 2**30), ("mb", 2**20), ("kb", 2**10), ("b", 1),
)


def _on_card(device) -> bool:
    return device is not None and getattr(device, "type", None) == "cuda"


def device_memory_sample(device) -> dict:
    """One device-memory poll: bytes in use, the allocator's peak and
    the card's total memory (``bytes_limit``); every figure None off
    the card (``source`` None)."""
    if not _on_card(device):
        return {"source": None, "bytes_in_use": None, "peak_bytes": None,
                "bytes_limit": None}
    import torch

    free, total = torch.cuda.mem_get_info(device)
    return {"source": "torch.cuda",
            "bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "bytes_reserved": int(torch.cuda.memory_reserved(device)),
            "peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "bytes_free": int(free), "bytes_limit": int(total)}


def ladder_report(device, warm_kinds) -> dict | None:
    """Run each ``(kind, warm_fn)`` of the ladder from a reset peak and
    read the allocator's peak after it: ``{"total_bytes": the peak over
    the whole ladder, "<kind>_peak_bytes": each kind's own}``, or None
    off the card (the functions still run)."""
    if not _on_card(device):
        for _, fn in warm_kinds:
            fn()
        return None
    import torch

    out: dict = {"source": "max_memory_allocated over the warmed ladder"}
    total = 0
    for kind, fn in warm_kinds:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
        out[f"{kind}_peak_bytes"] = max(peak,
                                        out.get(f"{kind}_peak_bytes", 0))
        total = max(total, peak)
    out["total_bytes"] = total
    return out


def parse_hbm_budget(spec) -> int | str | None:
    """``--hbm_budget`` → bytes, ``"auto"``, or None (off).

    Accepts a byte count with an optional binary suffix (``16GB``,
    ``900MB``, ``17179869184``), ``auto`` (resolve against the card's
    total memory at run start), or unset/off.  Loud on garbage — a
    typo'd budget must die at flag time (the JAX lane's rules and
    messages)."""
    if spec is None:
        return None
    s = str(spec).strip().lower()
    if s in ("", "off", "none", "0"):
        return None
    if s == "auto":
        return "auto"
    mult = 1
    for suf, m in _BUDGET_SUFFIXES:
        if s.endswith(suf):
            s, mult = s[: -len(suf)].strip(), m
            break
    try:
        val = float(s) * mult
    except ValueError:
        raise ValueError(
            f"--hbm_budget must be bytes (suffixes KB/MB/GB/TB), 'auto', "
            f"or unset/off: {spec!r}") from None
    if val <= 0:
        raise ValueError(f"--hbm_budget must be > 0: {spec!r}")
    return int(val)


def resolve_hbm_budget_bytes(parsed, device) -> tuple[int | None,
                                                      str | None]:
    """Resolve a parsed budget to bytes at run start.  ``auto`` reads
    the card's total memory; returns ``(None, note)`` off the card —
    the caller prints the note instead of silently skipping the
    check."""
    if parsed is None:
        return None, None
    if parsed != "auto":
        return int(parsed), None
    limit = device_memory_sample(device).get("bytes_limit")
    if limit:
        return int(limit), None
    return None, ("--hbm_budget=auto: this device exposes no memory "
                  "limit (torch.cuda statistics unavailable) — budget "
                  "check skipped; pass an explicit byte budget")


def _gib(n) -> str:
    return f"{(n or 0) / 2**30:.2f}"


def budget_lines(measured: dict | None, budget_bytes: int | None,
                 note: str | None = None,
                 advice: str | None = None) -> list[str]:
    """The pre-traffic budget verdict: a loud WARNING when the measured
    peak exceeds the budget, one quiet confirmation line otherwise."""
    advice = advice or ("shrink --serve_buckets/--max_in_flight, "
                        "--kv_pages, or --max_prompt_len/--max_output_len")
    if note:
        return [f"WARNING: {note}"]
    if budget_bytes is None:
        return []
    if not measured or not measured.get("total_bytes"):
        return ["WARNING: --hbm_budget: no memory report for this "
                "arm/device (no allocator peak off the card) — budget "
                "unchecked"]
    total = measured["total_bytes"]
    if total > budget_bytes:
        return [
            f"WARNING: --hbm_budget: measured peak {_gib(total)} GiB "
            f"allocated over the warmed ladder EXCEEDS the budget "
            f"{_gib(budget_bytes)} GiB — this run is likely to OOM; "
            f"{advice} before paying for the full run"]
    return [f"hbm budget: measured peak {_gib(total)} GiB allocated over "
            f"the warmed ladder fits the budget {_gib(budget_bytes)} GiB "
            f"({total / budget_bytes:.0%})"]


def live_tensor_breakdown(device, top_k: int = 24) -> dict:
    """Top-K live tensors on ``device`` (every device when None),
    aggregated by (shape, dtype): count and total bytes, largest
    first — which shape class owns the memory."""
    import gc
    import warnings

    import torch

    groups: dict[tuple, dict] = {}
    total = count = 0
    with warnings.catch_warnings():
        # the walk touches deprecated module attributes on its way
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        try:
            if obj.is_meta:
                continue
            if device is not None and obj.device.type != device.type:
                continue
            nbytes = int(obj.untyped_storage().nbytes())
            key = (tuple(obj.shape), str(obj.dtype))
        except Exception:
            continue
        count += 1
        total += nbytes
        g = groups.setdefault(key, {"shape": list(key[0]),
                                    "dtype": key[1], "count": 0,
                                    "nbytes": 0})
        g["count"] += 1
        g["nbytes"] += nbytes
    top = sorted(groups.values(), key=lambda g: -g["nbytes"])[:top_k]
    return {"total_live_bytes": total, "tensor_count": count,
            "top_tensors": top}


def dump_forensics(out_dir: str, reason: str, device=None,
                   step: int | None = None, top_k: int = 24,
                   print_fn=None) -> str | None:
    """Write ``memory_dump.json`` beside the metrics stream: the live
    tensors and, on the card, the allocator's statistics.  Returns the
    dump path, or None on any failure."""
    try:
        payload: dict = {"reason": reason, "step": step,
                         "t_unix": time.time()}
        payload.update(live_tensor_breakdown(device, top_k))
        payload["device_memory"] = device_memory_sample(device)
        path = os.path.join(out_dir, MEMORY_DUMP_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, default=str)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if print_fn is not None:
            print_fn(f"memory forensics ({reason}): {path} — "
                     f"{payload['tensor_count']} live tensor(s), "
                     f"{payload['total_live_bytes'] / 2**20:.1f} MiB")
        return path
    except Exception:
        return None
