"""Mergeable relative-error quantile sketch (DDSketch-style), the
port's copy of the JAX package's ``obs/sketch.py``.

Pure record processing, no torch: the serving summary's percentiles
and the ``latency_sketch`` windows fold through it, and the obs CLI
renders run directories on a machine with no GPU.

The sketch is a log-bucketed histogram: a positive value ``v`` lands in
bucket ``ceil(log_gamma(v))`` with ``gamma = (1+alpha)/(1-alpha)``, so
every bucket's representative value is within ``alpha`` *relative*
error of every sample it holds — 1% by default, at any quantile, over
any value range, in O(log range) buckets.  Two properties the repo's
stored-sample folds could never offer:

- **Bounded memory.**  A week-long serve adds samples forever; the
  sketch stays under ``max_buckets`` entries (the lowest buckets
  collapse first, degrading only the smallest-value quantiles — the
  tail the SLO reads is never the collapsed end).
- **Mergeable.**  ``merge`` is bucket-wise addition, so per-rank
  per-window sketches compose into *exact* fleet-wide percentiles —
  the merged sketch is byte-identical to the sketch of the
  concatenated streams, which per-host p99s averaged together are not.

Quantile convention: q in 0..100, rank ``q/100 * (count-1)``; exact min/max are tracked on the side so
the edge quantiles and the single-sample case are exact, not bucket
representatives.
"""

from __future__ import annotations

import math

DEFAULT_ALPHA = 0.01
DEFAULT_MAX_BUCKETS = 2048
# values at or below this land in the exact zero bucket (log of 0 is
# the alternative)
_ZERO_EPS = 1e-9


class QuantileSketch:
    """Sparse DDSketch over non-negative values with per-sample
    weights (negative inputs clamp to 0 — latency folds must never
    raise over a float-jitter -0.0)."""

    __slots__ = ("alpha", "gamma", "_log_gamma", "max_buckets",
                 "buckets", "zero_count", "count", "vmin", "vmax",
                 "total")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 max_buckets: int = DEFAULT_MAX_BUCKETS):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1): {alpha}")
        if max_buckets < 2:
            raise ValueError(f"max_buckets must be >= 2: {max_buckets}")
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.max_buckets = int(max_buckets)
        self.buckets: dict[int, float] = {}
        self.zero_count = 0.0
        self.count = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None
        self.total = 0.0

    def add(self, value: float, weight: float = 1.0) -> None:
        w = float(weight)
        if w <= 0.0:
            return
        v = max(0.0, float(value))
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self.count += w
        self.total += v * w
        if v <= _ZERO_EPS:
            self.zero_count += w
            return
        i = math.ceil(math.log(v) / self._log_gamma)
        self.buckets[i] = self.buckets.get(i, 0.0) + w
        if len(self.buckets) > self.max_buckets:
            self._collapse()

    def _collapse(self) -> None:
        """Fold the lowest buckets together until under the cap — the
        cheap end to degrade: SLO reads live in the upper tail."""
        keys = sorted(self.buckets)
        while len(keys) > self.max_buckets:
            lo = keys.pop(0)
            self.buckets[keys[0]] = (self.buckets.get(keys[0], 0.0)
                                     + self.buckets.pop(lo))

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Bucket-wise add; both sketches must share gamma (the bucket
        boundaries) or indices mean different values."""
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different alpha: "
                f"{self.alpha} vs {other.alpha}")
        for i, w in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0.0) + w
        self.zero_count += other.zero_count
        self.count += other.count
        self.total += other.total
        if other.vmin is not None:
            self.vmin = (other.vmin if self.vmin is None
                         else min(self.vmin, other.vmin))
        if other.vmax is not None:
            self.vmax = (other.vmax if self.vmax is None
                         else max(self.vmax, other.vmax))
        if len(self.buckets) > self.max_buckets:
            self._collapse()
        return self

    def quantile(self, q: float) -> float:
        """q in 0..100.  Returns the bucket representative of the sample at rank
        ``q/100 * (count-1)``, clamped into [min, max] — within
        ``alpha`` relative error of that order statistic."""
        if self.count <= 0.0:
            return 0.0
        if self.vmin == self.vmax:
            return float(self.vmin)
        rank = max(0.0, min(q, 100.0)) / 100.0 * (self.count - 1.0)
        acc = self.zero_count
        if acc > rank:
            return float(self.vmin)
        for i in sorted(self.buckets):
            acc += self.buckets[i]
            if acc > rank:
                rep = 2.0 * self.gamma ** i / (self.gamma + 1.0)
                return float(min(max(rep, self.vmin), self.vmax))
        return float(self.vmax)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_record(self) -> dict:
        """JSON-serializable form (bucket keys become strings; weights
        round to micro-counts so the stream stays compact)."""
        return {
            "alpha": self.alpha,
            "max_buckets": self.max_buckets,
            "count": round(self.count, 6),
            "zero": round(self.zero_count, 6),
            "min": self.vmin,
            "max": self.vmax,
            "total": round(self.total, 6),
            "buckets": {str(i): round(w, 6)
                        for i, w in sorted(self.buckets.items())},
        }

    @classmethod
    def from_record(cls, rec: dict) -> "QuantileSketch":
        sk = cls(alpha=float(rec.get("alpha", DEFAULT_ALPHA)),
                 max_buckets=int(rec.get("max_buckets",
                                         DEFAULT_MAX_BUCKETS)))
        sk.count = float(rec.get("count", 0.0))
        sk.zero_count = float(rec.get("zero", 0.0))
        sk.vmin = rec.get("min")
        sk.vmax = rec.get("max")
        sk.total = float(rec.get("total", 0.0))
        sk.buckets = {int(k): float(w)
                      for k, w in (rec.get("buckets") or {}).items()}
        return sk

    @classmethod
    def from_counts(cls, counts, alpha: float = DEFAULT_ALPHA,
                    max_buckets: int = DEFAULT_MAX_BUCKETS
                    ) -> "QuantileSketch":
        """Sketch of an integer-indexed histogram (``counts[v]`` =
        occurrences of value ``v``) — the service stall/occupancy
        histograms' shape."""
        sk = cls(alpha=alpha, max_buckets=max_buckets)
        for v, n in enumerate(counts):
            if n:
                sk.add(float(v), float(n))
        return sk


def sketch_of(values, alpha: float = DEFAULT_ALPHA) -> QuantileSketch:
    sk = QuantileSketch(alpha=alpha)
    for v in values:
        sk.add(float(v))
    return sk


def merge_records(records) -> QuantileSketch | None:
    """Merge an iterable of ``to_record`` payloads (per-rank
    per-window sketches off the stream) into one sketch, or None when
    the iterable is empty — absent history folds to absent, labeled,
    never a KeyError."""
    merged: QuantileSketch | None = None
    for rec in records:
        if not isinstance(rec, dict):
            continue
        sk = QuantileSketch.from_record(rec)
        merged = sk if merged is None else merged.merge(sk)
    return merged
