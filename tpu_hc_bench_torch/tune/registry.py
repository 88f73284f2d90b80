"""The tuned-config registry: ``artifacts/tuned/<hardware_key>.json``
(the port's copy of the JAX package's ``tune/registry.py``).

A tuned config is only meaningful on the hardware it was measured on,
so rows are keyed by a *hardware key* — the device's name + its memory
+ world size (``nvidia_h100_80gb_hbm3-79gb-w1``, ``cpu-0gb-w1``).  One
JSON file per hardware key holds one row per zoo member: the winning
lever overrides, the score, and provenance (search status, spent
seconds, measured steps).

Consumers:

- ``--config=auto`` (``resolve()`` of both lanes' configs): look up the
  row for (member, live hardware), apply its overrides to every lever
  the user did not set, and record ``config_source=auto``; no row falls
  back LOUDLY to the flag defaults (``config_source=baseline``) — never
  silently.
- ``python -m tpu_hc_bench_torch.tune promote`` writes rows from a
  finished search journal; ``show`` renders them.

Environment overrides (tests, cross-machine workflows):
``TPU_HC_TUNE_REGISTRY`` points at a different registry dir;
``TPU_HC_TUNE_HW`` pins the hardware key without querying the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

__all__ = [
    "REGISTRY_ENV", "HW_ENV", "default_registry_dir", "registry_path",
    "hardware_key", "load_rows", "lookup", "promote", "resolve_auto",
]

REGISTRY_ENV = "TPU_HC_TUNE_REGISTRY"
HW_ENV = "TPU_HC_TUNE_HW"


def default_registry_dir() -> Path:
    env = os.environ.get(REGISTRY_ENV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "artifacts" / "tuned"


def hardware_key(world: int | None = None,
                 device: str | None = None) -> str:
    """``<device-kind>-<mem_gb>gb-w<world>`` from the live card (or the
    ``TPU_HC_TUNE_HW`` pin).

    The three components are exactly what changes a best-known config:
    the card (its peak), its memory (the batch and accumulator-dtype
    walls), and the world size (collective bytes a step, each card's
    share of the global batch).  The kind is
    ``torch.cuda.get_device_name()`` lower-cased with spaces and ``/``
    as ``_``; the memory is ``obs.memory``'s ``bytes_limit`` in whole
    GiB; the world is ``torch.distributed``'s when it is initialised,
    else 1.  ``device="cpu"`` (a run under ``--device=cpu``) keys the
    CPU, ``cpu-0gb-w<world>``; with no card, no CPU request and no pin
    this raises: a row measured on one device is never keyed to
    another.
    """
    env = os.environ.get(HW_ENV)
    if env:
        return env
    import torch
    import torch.distributed as dist

    if world is None:
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
    if device == "cpu":
        return f"cpu-0gb-w{world}"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hardware_key: no CUDA device (torch.cuda.is_available() is "
            "False): ask for the CPU (a run's --device=cpu), name the key "
            f"(the tune CLI's --hardware) or pin it with {HW_ENV}")
    from tpu_hc_bench_torch.obs.memory import device_memory_sample

    dev = torch.device("cuda", torch.cuda.current_device())
    kind = (torch.cuda.get_device_name(dev).lower()
            .replace(" ", "_").replace("/", "_"))
    limit = device_memory_sample(dev)["bytes_limit"] or 0
    return f"{kind}-{int(round(limit / 2**30))}gb-w{world}"


def registry_path(hardware: str,
                  registry_dir: str | Path | None = None) -> Path:
    base = Path(registry_dir) if registry_dir else default_registry_dir()
    return base / f"{hardware}.json"


def load_rows(hardware: str,
              registry_dir: str | Path | None = None) -> dict:
    """The hardware key's member rows (``{}`` when none exist)."""
    path = registry_path(hardware, registry_dir)
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return data.get("members", {})


def lookup(model: str, hardware: str,
           registry_dir: str | Path | None = None) -> dict | None:
    return load_rows(hardware, registry_dir).get(model)


def promote(journal: dict,
            registry_dir: str | Path | None = None,
            hardware: str | None = None) -> tuple[Path, dict]:
    """Write a finished journal's best config as the member's registry
    row (merging into the hardware file, tmp→rename committed).
    Returns (path, row)."""
    from tpu_hc_bench_torch.tune.search import commit_json

    best = journal.get("best")
    if not best:
        raise ValueError(
            "journal has no successful measurement to promote "
            f"(status {journal.get('status')!r})")
    hardware = hardware or journal["hardware"]
    model = journal["model"]
    if journal.get("workload", "train") == "serve":
        # serving rows are lane-keyed: resolve_auto's serve lookup
        # reads `<model>@serve`, never the training key
        model = f"{model}@serve"
    rec = best.get("record") or {}
    row = {
        "overrides": dict(best["overrides"]),
        "base": dict(best.get("base") or {}),
        "score": best["score"],
        "images_per_sec_per_chip": rec.get("per_chip"),
        "goodput": rec.get("goodput"),
        "mfu_pct": rec.get("mfu_pct"),
        # the best RECORD's own measured length (a candidate promoted
        # off a shallower rung must not claim the final rung's steps)
        "measured_batches": rec.get(
            "measured_batches",
            journal["rungs"][-1]["batches"]
            if journal.get("rungs") else None),
        "search_status": journal.get("status"),
        "spent_s": journal.get("spent_s"),
    }
    path = registry_path(hardware, registry_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        data = json.loads(path.read_text())
    else:
        data = {"hardware": hardware, "members": {}}
    data["members"][model] = row
    commit_json(str(path), data)
    return path, row


def resolve_auto(cfg) -> str:
    """The ``--config=auto`` hook both lanes' ``resolve()`` call
    (``flags.BenchmarkConfig`` for training, ``flags.ServeConfig`` for
    serving: the lane, its lever tuple and its field defaults come from
    the config's own class).

    Mutates ``cfg`` in place: applies the registry row's lever
    overrides to every field the operator did not pin (an explicit
    user flag wins over the registry — the operator's
    ``--batch_size=64 --config=auto`` measures the tuned config AT that
    batch), stamps ``config_source`` (``auto`` | ``baseline``) and
    ``tuned_config``, and returns the translation note for the banner.

    "Pinned" means: named in ``cfg.explicit_flags`` when the config
    came through a flag parser (which records what the operator
    actually typed, so an explicit flag set to its default value still
    pins), else any field whose value differs from the dataclass
    default (the programmatic-construction fallback).
    """
    from tpu_hc_bench_torch.flags import ServeConfig

    lane = "serve" if isinstance(cfg, ServeConfig) else "train"
    hw = hardware_key(device=getattr(cfg, "device", None))
    # the serving lane's rows are keyed `<model>@serve` — one member
    # can hold a tuned row per lane, and a training lookup can never
    # apply serving knobs (or vice versa)
    member = f"{cfg.model}@serve" if lane == "serve" else cfg.model
    row = lookup(member, hw)
    if row is None:
        cfg.config_source = "baseline"
        have = sorted(load_rows(hw))
        return (f"auto->BASELINE defaults: no tuned row for "
                f"{member!r} at hardware {hw!r} "
                f"({registry_path(hw)}"
                + (f" has {', '.join(have)}" if have
                   else " does not exist")
                + ") — run `python -m tpu_hc_bench_torch.tune search "
                  f"--model {cfg.model}`")
    defaults = {f.name: f.default for f in dataclasses.fields(type(cfg))}
    explicit = getattr(cfg, "explicit_flags", None)

    def pinned(k: str) -> bool:
        if explicit is not None:
            return k in explicit
        return getattr(cfg, k) != defaults.get(k)

    from tpu_hc_bench_torch.tune.space import LEVERS, SERVE_LEVERS

    lane_levers = SERVE_LEVERS if lane == "serve" else LEVERS
    applied, kept = [], []
    for k, v in {**row.get("base", {}), **row["overrides"]}.items():
        if k in (LEVERS + SERVE_LEVERS) and k not in lane_levers:
            # a lane-crossed row (e.g. a hand-edited @serve row
            # spelling a training lever) — applying it would smuggle
            # the other lane's knob past resolve()'s validity matrix.
            # Checked first: the port's two config classes lack the
            # other lane's fields, and JAX's one class has them all
            kept.append(f"{k} (not a {lane}-lane lever)")
            continue
        if not hasattr(cfg, k):
            # a stale row (flag renamed since the search) must not
            # crash every run; the note names it
            kept.append(f"{k} (unknown flag)")
            continue
        if not pinned(k):
            setattr(cfg, k, v)
            applied.append(f"{k}={v}")
        else:
            kept.append(f"{k}={getattr(cfg, k)} (explicit flag wins)")
    cfg.config_source = "auto"
    cfg.tuned_config = {"hardware": hw, "model": member, **row}
    note = (f"auto->tuned row {member}@{hw} "
            f"(score {row.get('score')}): "
            + (", ".join(applied) if applied else "no field changed"))
    if kept:
        note += "; kept: " + ", ".join(kept)
    return note
