"""Device memory of both lanes: the ``--hbm_budget`` check, device-memory
samples, the phase-attributed ledger, the analytic table and the
forensics dump (the port's counterpart of the JAX package's
``obs/memory.py``).

The training lane, as JAX's: ``analytic_memory_table`` (parameter,
optimizer-state and batch bytes from the live tensors),
``memory_report``/``memory_report_lines`` (the measured report beside
it), ``MemoryLedger`` (one sample a sync window, the high water
attributed to the goodput phase it rose in), ``fold_memory_records``/
``memory_lines`` (the same fold from the stream, for ``summarize``) and
the OOM and emergency forensics.  The measured report is the first
warmup step's allocator peak (``torch.cuda.max_memory_allocated`` from
a reset), where JAX reads the compiled step's AOT
``memory_analysis()``: eager PyTorch compiles nothing ahead of time, so
``--hbm_budget`` for training is checked after the first warmup step,
before the timed loop.

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
(``torch.cuda.get_device_properties``).

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


def device_memory_sample(device, free: bool = False) -> dict:
    """One device-memory poll: bytes in use, the allocator's peak and
    the card's total memory (``bytes_limit``), from the caching
    allocator's host-side counters; with ``free`` also the driver's free
    bytes (``cudaMemGetInfo``, which may wait for the device: not for a
    poll inside the step loop).  Every figure None off the card
    (``source`` None)."""
    if not _on_card(device):
        return {"source": None, "bytes_in_use": None, "peak_bytes": None,
                "bytes_limit": None}
    import torch

    out = {"source": "torch.cuda",
           "bytes_in_use": int(torch.cuda.memory_allocated(device)),
           "bytes_reserved": int(torch.cuda.memory_reserved(device)),
           "peak_bytes": int(torch.cuda.max_memory_allocated(device)),
           "bytes_limit": int(torch.cuda.get_device_properties(
               device).total_memory)}
    if free:
        out["bytes_free"] = int(torch.cuda.mem_get_info(device)[0])
    return out


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
                 advice: str | None = None,
                 where: str = "over the warmed ladder") -> list[str]:
    """The pre-traffic budget verdict: a loud WARNING when the measured
    peak exceeds the budget, one quiet confirmation line otherwise;
    ``where`` says what the peak was measured over."""
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
            f"allocated {where} EXCEEDS the budget "
            f"{_gib(budget_bytes)} GiB — this run is likely to OOM; "
            f"{advice} before paying for the full run"]
    return [f"hbm budget: measured peak {_gib(total)} GiB allocated "
            f"{where} fits the budget {_gib(budget_bytes)} GiB "
            f"({total / budget_bytes:.0%})"]


# ---------------------------------------------------------------------
# the training lane: analytic table, measured report, phase ledger

#: the >10 % disagreement tripwire between measured and analytic bytes
ARGS_DISAGREE_FRAC = 0.10


def _tensor_bytes(tensors) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors
               if hasattr(t, "numel"))


def _batch_leaves(batch) -> list:
    if isinstance(batch, (tuple, list)):
        return [x for b in batch for x in _batch_leaves(b)]
    return [batch] if hasattr(batch, "numel") else []


def analytic_memory_table(model, optimizer=None, batch=None) -> dict:
    """Parameter, optimizer-state and batch bytes from the live tensors
    (host arithmetic over shapes; no device touch), and their sum; the
    BatchNorm statistics are out of it, as out of JAX's ``params``.
    Activations are absent: they have no honest analytic twin; the
    measured peak is their measurement."""
    opt = [v for st in (optimizer.state.values() if optimizer else ())
           for v in st.values() if hasattr(v, "numel")]
    out = {"params_bytes": _tensor_bytes(list(model.parameters())),
           "opt_bytes": _tensor_bytes(opt),
           "batch_bytes": _tensor_bytes(_batch_leaves(batch))}
    out["state_bytes"] = (out["params_bytes"] + out["opt_bytes"]
                          + out["batch_bytes"])
    return out


def first_step_report(device, run_step) -> dict | None:
    """``run_step()`` from a reset allocator peak: ``{"total_bytes": the
    peak allocated, "temp_bytes": the peak above what was allocated
    before it}``; None off the card (the step still runs).  The caller
    adds ``argument_bytes`` once the optimizer's state exists."""
    if not _on_card(device):
        run_step()
        return None
    import torch

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = int(torch.cuda.memory_allocated(device))
    run_step()
    torch.cuda.synchronize(device)
    peak = int(torch.cuda.max_memory_allocated(device))
    return {"source": "max_memory_allocated over the first warmup step",
            "temp_bytes": peak - before, "total_bytes": peak}


def memory_report(measured: dict | None, analytic: dict) -> dict:
    """The measured bytes source-labelled beside the analytic table, with
    the >10 % disagreement flag between the bytes held between steps
    (``argument_bytes``) and the analytic params+opt+batch sum."""
    out: dict = {"analytic": dict(analytic), "mem_source": "analytic"}
    if measured:
        out["measured"] = dict(measured)
        out["mem_source"] = "measured"
        args_analytic = analytic.get("state_bytes", 0)
        args_measured = measured.get("argument_bytes")
        if args_analytic > 0 and args_measured:
            rel = abs(args_measured - args_analytic) / args_analytic
            out["args_disagreement"] = rel
            out["args_disagree"] = rel > ARGS_DISAGREE_FRAC
    return out


def _mib(n) -> str:
    return f"{(n or 0) / 2**20:.1f}"


def memory_report_lines(rec: dict) -> list[str]:
    """Render a ``memory_report`` record (the driver's final print and
    ``obs summarize``), in JAX's words where the fields are JAX's."""
    if not rec:
        return []
    analytic = rec.get("analytic") or {}
    measured = rec.get("measured")
    if measured:
        head = (f"  memory (first step): held "
                f"{_mib(measured.get('argument_bytes'))} MiB  temp "
                f"{_mib(measured.get('temp_bytes'))} MiB  peak "
                f"{_mib(measured.get('total_bytes'))} MiB")
    else:
        head = "  memory (first step): unavailable on this device"
    head += (f"  (analytic: params {_mib(analytic.get('params_bytes'))}"
             f" + opt {_mib(analytic.get('opt_bytes'))}"
             f" + batch {_mib(analytic.get('batch_bytes'))}"
             f" = {_mib(analytic.get('state_bytes'))} MiB)")
    lines = [head]
    if rec.get("args_disagree"):
        lines.append(
            f"  WARNING: bytes held between steps disagree "
            f"{rec.get('args_disagreement', 0.0):.0%} with the analytic "
            f"params+opt+batch table: measured "
            f"{_mib((rec.get('measured') or {}).get('argument_bytes'))} vs "
            f"analytic {_mib(analytic.get('state_bytes'))} MiB")
    return lines


class MemoryLedger:
    """Per-run device-memory high water, attributed to goodput phases
    (JAX's ledger).  ``sample(phase, step)`` is called once per sync
    window (and at checkpoint, rewind and emergency boundaries); the
    returned record goes into the stream as one ``memory`` record.  The
    ledger keeps the running peak and the phase it rose in, and
    per-phase maxima of the sampled in-use bytes.  Off the card a
    sample has no figures and the ledger stays empty.  ``sample_fn``
    is injectable for tests."""

    def __init__(self, device=None, sample_fn=None):
        self._sample_fn = sample_fn or (
            lambda: device_memory_sample(device))
        self.peak_bytes = 0
        self.peak_phase: str | None = None
        self.per_phase: dict[str, int] = {}
        self.source: str | None = None
        self.bytes_limit: int | None = None

    def sample(self, phase: str, step: int | None = None) -> dict:
        s = dict(self._sample_fn())
        self.source = s.get("source") or self.source
        if s.get("bytes_limit"):
            self.bytes_limit = s["bytes_limit"]
        high = s.get("peak_bytes") or s.get("bytes_in_use") or 0
        usage = s.get("bytes_in_use") or high
        if usage:
            self.per_phase[phase] = max(self.per_phase.get(phase, 0), usage)
        if high > self.peak_bytes:
            self.peak_bytes = high
            self.peak_phase = phase
        s["phase"] = phase
        s["step"] = step
        return s

    def fold(self) -> dict | None:
        """The ledger's account in ``fold_memory_records``'s shape."""
        if self.peak_bytes <= 0:
            return None
        return {"peak_bytes": self.peak_bytes,
                "peak_phase": self.peak_phase,
                "per_phase": dict(self.per_phase),
                "source": self.source,
                "bytes_limit": self.bytes_limit}


def fold_memory_records(records: list[dict]) -> dict | None:
    """Fold a run's ``memory`` records (JAX's fold, the ``summarize``
    half of the ledger)."""
    peak = 0
    peak_phase: str | None = None
    per_phase: dict[str, int] = {}
    source = None
    limit = None
    seen = False
    for r in records:
        if r.get("kind") != "memory":
            continue
        seen = True
        if "bytes_in_use" in r or "peak_bytes" in r:
            high = r.get("peak_bytes") or r.get("bytes_in_use") or 0
            usage = r.get("bytes_in_use") or high
            phase = r.get("phase")
            source = r.get("source") or source
            if r.get("bytes_limit"):
                limit = r["bytes_limit"]
        else:       # JAX's legacy end-of-run record
            devices = r.get("devices") or {}
            high = max((v.get("peak_bytes_in_use", 0)
                        for v in devices.values()), default=0)
            usage = high
            phase = None
            source = source or ("memory_stats" if devices else None)
        if phase and usage:
            per_phase[phase] = max(per_phase.get(phase, 0), usage)
        if high > peak:
            peak, peak_phase = high, phase
    if not seen or peak <= 0:
        return None
    return {"peak_bytes": peak, "peak_phase": peak_phase,
            "per_phase": per_phase, "source": source,
            "bytes_limit": limit}


def memory_lines(fold: dict | None) -> list[str]:
    """Render a ``fold_memory_records`` result (summarize and driver)."""
    if not fold:
        return []
    head = f"  memory: peak {_mib(fold['peak_bytes'])} MiB"
    if fold.get("bytes_limit"):
        head += (f" of {fold['bytes_limit'] / 2**30:.1f} GiB limit "
                 f"({fold['peak_bytes'] / fold['bytes_limit']:.0%})")
    head += f"  (source: {fold.get('source') or '?'}"
    if fold.get("peak_phase"):
        head += f"; high-water set in phase {fold['peak_phase']}"
    head += ")"
    lines = [head]
    per_phase = fold.get("per_phase") or {}
    if per_phase:
        from tpu_hc_bench_torch.obs import goodput as goodput_mod

        order = [p for p in goodput_mod.PHASES if p in per_phase]
        order += [p for p in per_phase if p not in order]
        lines.append("    per-phase peaks (MiB): " + "  ".join(
            f"{p} {_mib(per_phase[p])}" for p in order))
    return lines


def is_oom_error(exc: BaseException | str) -> bool:
    """Device-memory exhaustion, by message: PyTorch's
    ``torch.OutOfMemoryError`` ("CUDA out of memory") and the JAX
    lane's spellings."""
    msg = str(exc)
    return (type(exc).__name__ == "OutOfMemoryError" or any(
        tok in msg for tok in ("RESOURCE_EXHAUSTED", "Out of memory",
                               "out of memory", "failed to allocate")))


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
        payload["device_memory"] = device_memory_sample(device, free=True)
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
