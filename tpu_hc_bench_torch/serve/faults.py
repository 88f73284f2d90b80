"""Serve-lane fault injection and the drain/resume journal, the port of
the JAX package's ``serve/faults.py``.

``--serve_faults`` takes comma-separated ``CLASS@WHERE[:ARG]`` entries,
parsed and refused exactly as the JAX lane does (the same splitter and
the same message, which names both lanes' grammars):

- ``hang@STEP:SECONDS``: the scheduler stalls SECONDS of real time
  before decode step STEP (what the watchdog exists for);
- ``nan_logits@RID``: request RID's logits are made non-finite on the
  host, after the program returned, the next time RID occupies a
  prefill or decode row (the quarantine path);
- ``sigterm@T``: a real SIGTERM to this process at engine-clock T
  seconds (the drain, journal and exit-75 path);
- ``pool_squeeze@T:PAGES``: PAGES KV pages withheld from admission from
  engine-clock T on, sticky (the KV-pressure preemption path).

The journal is the drain's commit: every unfinished request (queued,
not yet arrived, or preempted mid-generation) written with tmp, fsync,
rename, so a SIGTERM'd server leaves a whole journal or none.  Its JSON
is the JAX lane's file format, so either package reads the other's;
``serve --serve_resume=<journal>`` replays each entry exactly once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal

from tpu_hc_bench_torch.resilience.inject import (  # noqa: F401
    SERVE_VOCAB, TRAIN_VOCAB, malformed, split_entries)

JOURNAL_NAME = "serve_journal.json"


@dataclasses.dataclass
class ServeFaultPlan:
    hang: dict[int, float]          # decode step -> seconds
    nan_logits: frozenset[int]      # request ids to poison
    sigterm: tuple[float, ...]      # engine-clock seconds
    pool_squeeze: tuple[tuple[float, int], ...]  # (t_s, pages) sticky

    def __bool__(self) -> bool:
        return bool(self.hang or self.nan_logits or self.sigterm
                    or self.pool_squeeze)

    # -- engine hooks (all host-side, all cheap when inert) ------------

    def hang_before_decode(self, decode_step: int) -> float:
        """Seconds to stall before decode step ``decode_step`` (0.0
        when none scheduled); one-shot per step number."""
        return self.hang.pop(decode_step, 0.0)

    def poison_rids(self, rids) -> list[int]:
        """The subset of ``rids`` whose logits rows must be poisoned
        this call (one-shot per rid: the quarantine retires it)."""
        if not self.nan_logits:
            return []
        hit = [r for r in rids if r in self.nan_logits]
        if hit:
            self.nan_logits = self.nan_logits - frozenset(hit)
        return hit

    def sigterm_due(self, t: float) -> bool:
        """True once per scheduled time <= ``t``; the caller delivers a
        REAL signal so the drain path under test is the production one."""
        due = [s for s in self.sigterm if s <= t]
        if due:
            self.sigterm = tuple(s for s in self.sigterm if s > t)
        return bool(due)

    def deliver_sigterm(self) -> None:
        os.kill(os.getpid(), signal.SIGTERM)

    def squeezed_pages(self, t: float) -> int:
        """KV pages withheld from the allocator at engine-clock ``t``
        (sticky: every trigger whose time has passed stays applied)."""
        return sum(p for at, p in self.pool_squeeze if t >= at)


def parse_serve_plan(spec: str | None) -> ServeFaultPlan | None:
    """Parse the --serve_faults grammar; None/empty spec -> None."""
    if not spec:
        return None
    hang: dict[int, float] = {}
    nan_logits: set[int] = set()
    sigterm: list[float] = []
    squeeze: list[tuple[float, int]] = []
    for cls, where, arg, entry in split_entries(spec, lane="serve"):
        try:
            if cls == "hang":
                if arg is None:
                    raise ValueError
                hang[_int_ge(where, 1)] = _pos_float(arg)
            elif cls == "nan_logits":
                if arg is not None:
                    raise ValueError
                nan_logits.add(_int_ge(where, 0))
            elif cls == "sigterm":
                if arg is not None:
                    raise ValueError
                sigterm.append(_nonneg_float(where))
            elif cls == "pool_squeeze":
                if arg is None:
                    raise ValueError
                squeeze.append((_nonneg_float(where), _int_ge(arg, 1)))
            else:
                raise ValueError
        except ValueError:
            raise ValueError(malformed(entry, "serve")) from None
    return ServeFaultPlan(hang=hang, nan_logits=frozenset(nan_logits),
                          sigterm=tuple(sorted(sigterm)),
                          pool_squeeze=tuple(sorted(squeeze)))


def _int_ge(s: str, floor: int) -> int:
    v = int(s)
    if v < floor:
        raise ValueError
    return v


def _pos_float(s: str) -> float:
    v = float(s)
    if v <= 0:
        raise ValueError
    return v


def _nonneg_float(s: str) -> float:
    v = float(s)
    if v < 0:
        raise ValueError
    return v


# ---------------------------------------------------------------------
# drain journal: the serving lane's "emergency checkpoint"


def journal_entry(req, produced: int = 0, prefix=None,
                  preempts: int = 0) -> dict:
    """One unfinished request as a journal row.  ``prefix`` (generated
    tokens so far) is carried for the record — the replay re-serves the
    request from scratch, which regenerates the same tokens from the
    same seeded model, so exactly-once means exactly one terminal
    record per rid in the resumed run."""
    prompt = getattr(req, "prompt", None)
    return {
        "rid": int(req.rid),
        "arrival_s": float(req.arrival_s),
        "prompt": None if prompt is None else [int(t) for t in prompt],
        "output_len": int(req.output_len),
        "produced": int(produced),
        "prefix": [int(t) for t in (prefix or ())],
        "preempts": int(preempts),
    }


def write_journal(path: str, entries: list[dict], *,
                  model: str | None = None, seed=None,
                  reason: str = "sigterm") -> str:
    """Commit the drain journal with tmp -> fsync -> rename (the
    checkpoint-sentinel idiom): a crash mid-write leaves no torn
    journal for ``--serve_resume`` to half-replay."""
    payload = {
        "kind": "serve_journal",
        "reason": reason,
        "model": model,
        "seed": seed,
        "unfinished": len(entries),
        "requests": sorted(entries, key=lambda e: (e["arrival_s"],
                                                   e["rid"])),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_journal(path: str) -> dict:
    """Load + validate a drain journal; loud on a missing or non-journal
    file (a resume pointed at the wrong path must not silently serve
    zero requests)."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("kind") != "serve_journal" \
            or not isinstance(payload.get("requests"), list):
        raise ValueError(
            f"{path} is not a serve drain journal (expected kind="
            f"'serve_journal' with a 'requests' list)")
    return payload


def journal_requests(payload: dict) -> list:
    """Journal rows -> ``arrivals.Request`` objects for the resumed
    run, arrival order preserved."""
    import numpy as np

    from tpu_hc_bench_torch.serve.arrivals import Request

    out = []
    for row in payload["requests"]:
        prompt = row.get("prompt")
        out.append(Request(
            rid=int(row["rid"]),
            arrival_s=float(row["arrival_s"]),
            prompt=(None if prompt is None
                    else np.asarray(prompt, dtype=np.int32)),
            output_len=int(row["output_len"])))
    return out
