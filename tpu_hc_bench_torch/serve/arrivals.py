"""Seeded synthetic request arrival processes + request synthesis.

A copy of the JAX package's ``serve/arrivals.py``; the rng keys are the
same, so a (process, rate, n, seed) tuple names the same trace in both.

"Millions of users" scaled down to an arrival-rate axis: the serving
benchmark is *open-loop* — requests arrive on their own schedule whether
or not the engine keeps up, so queueing delay is measured instead of
hidden (a closed client-loop would throttle arrivals to service rate
and report flattering latencies).  Three shapes:

- ``poisson``: memoryless exponential gaps at ``rate`` — the classic
  open-loop model, and the headline A/B's fixed-rate axis.
- ``bursty``: an on/off duty cycle — ``burst_factor`` x the mean rate
  for the first quarter of each ``period_s``, near-idle otherwise.
  Same mean rate as poisson; the tail (p99) is where it hurts.
- ``diurnal``: a sinusoidal rate over ``period_s`` (the day/night
  traffic curve, compressed) via Lewis-Shedler thinning.

Everything is drawn from ``numpy.random.default_rng`` keyed on the
seed, so a (process, rate, n, seed) tuple names one exact trace —
reproducible across machines and independent of engine pacing (the
``data/tokens.py`` counter-rng discipline).
"""

from __future__ import annotations

import dataclasses

import numpy as np

PROCESSES = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class Request:
    """One synthetic inference request.

    ``prompt`` is the int32 token array for decode members and ``None``
    for classify members (non-text zoo members serve single-forward
    requests); ``output_len`` is the generation budget — a decode
    request retires after ``output_len`` tokens.
    """

    rid: int
    arrival_s: float
    prompt: np.ndarray | None
    output_len: int

    @property
    def prompt_len(self) -> int:
        return 0 if self.prompt is None else int(len(self.prompt))


def arrival_times(process: str, rate: float, n: int, seed: int = 0,
                  burst_factor: float = 4.0,
                  period_s: float = 8.0) -> np.ndarray:
    """``n`` sorted arrival offsets (seconds from t=0) at mean ``rate``.

    All three processes share the mean: an A/B over arrival *shape*
    holds offered load fixed.
    """
    if process not in PROCESSES:
        raise ValueError(
            f"arrival process must be one of {PROCESSES}: {process!r}")
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0: {rate}")
    if n < 1:
        raise ValueError(f"need >= 1 arrival: {n}")
    rng = np.random.default_rng((seed, 3))
    if process == "poisson":
        gaps = rng.exponential(1.0 / rate, size=n)
        return np.cumsum(gaps)
    # time-varying lambda(t), sampled by Lewis-Shedler thinning against
    # the process's peak rate: candidates at rate_max, kept with
    # probability lambda(t)/rate_max — exact for any bounded lambda
    duty = 0.25
    if process == "bursty":
        peak = rate * burst_factor

        def lam(t):
            # mean over a period = duty*peak + (1-duty)*low == rate
            low = max(0.0, rate * (1.0 - duty * burst_factor)
                      / (1.0 - duty))
            return np.where((t % period_s) < duty * period_s, peak, low)
    else:                                   # diurnal
        peak = 2.0 * rate

        def lam(t):
            return rate * (1.0 + np.sin(2.0 * np.pi * t / period_s))

    out: list[float] = []
    t = 0.0
    while len(out) < n:
        t += float(rng.exponential(1.0 / peak))
        if float(rng.random()) * peak <= float(lam(np.float64(t))):
            out.append(t)
    return np.asarray(out)


def sample_lengths(n: int, max_len: int, seed: int = 0,
                   mean_frac: float = 0.5) -> np.ndarray:
    """``n`` request lengths in ``[1, max_len]``: lognormal body (the
    long-tail shape of real prompt/output distributions) clipped at the
    ceiling, keyed off the seed."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1: {max_len}")
    rng = np.random.default_rng((seed, 5))
    body = rng.lognormal(mean=np.log(max(1.0, mean_frac * max_len)),
                         sigma=0.6, size=n)
    return np.clip(np.round(body), 1, max_len).astype(np.int64)


def build_requests(cfg, vocab_size: int | None,
                   seed: int | None = None) -> list[Request]:
    """The run's full request trace from a resolved serve config.

    ``vocab_size`` None = classify member (no prompts, one forward per
    request).  Deterministic per (cfg arrival knobs, seed): the engine,
    the A/B control arm, and a re-run all see the identical trace.
    """
    seed = cfg.seed if seed is None else seed
    times = arrival_times(cfg.arrival, cfg.arrival_rate,
                          cfg.num_requests, seed=seed)
    out_lens = sample_lengths(cfg.num_requests, cfg.max_output_len,
                              seed=seed + 1)
    if vocab_size is None:
        return [Request(rid=i, arrival_s=float(times[i]), prompt=None,
                        output_len=1)
                for i in range(cfg.num_requests)]
    from tpu_hc_bench_torch.data.tokens import PromptSampler

    prompt_lens = sample_lengths(cfg.num_requests, cfg.max_prompt_len,
                                 seed=seed + 2)
    sampler = PromptSampler(vocab_size=vocab_size,
                            data_dir=cfg.data_dir,
                            seed=seed)
    return [
        Request(rid=i, arrival_s=float(times[i]),
                prompt=sampler.sample(i, int(prompt_lens[i])),
                output_len=int(out_lens[i]))
        for i in range(cfg.num_requests)
    ]
