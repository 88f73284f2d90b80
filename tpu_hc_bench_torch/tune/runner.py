"""The one subprocess runner behind the tuner (the port's copy of the JAX
package's ``tune/runner.py``).

The successive-halving search needs one thing: launch ``python -m
tpu_hc_bench_torch 1 <workers> <batch> ici --model=<m> <flags...>`` in
a subprocess, enforce a timeout, classify the launcher's exit-code
contract (0 ok / 1 zero-throughput / 70 watchdog / 75 preempted —
``tpu_hc_bench_torch.resilience.EXIT_CLASSES``), and parse one result
record.

Every launch puts the job in its OWN process group
(``start_new_session=True``) and every kill targets the *group*
(``kill_process_tree``): a training job hosts feeder threads, decode
pools, and — under the input service — real grandchild processes, and
a timeout that only killed the direct child would orphan them onto the
host's CPUs.

Result parsing prefers the machine-readable path: with ``metrics_dir``
set, the run's ``metrics.jsonl`` final ``summary`` record (the
``BenchmarkResult`` fields as one JSON line, goodput included) is the
source of truth; the stdout ``images/sec/chip:`` line is the fallback
for runs without a metrics artifact.

The *score* the search ranks by is goodput-adjusted throughput:
``images_per_sec_per_chip x goodput`` — a config that wins on raw
step rate but spends its wall in warmup or blocked on input loses to
one that keeps the card productive.  Runs without a ledger (NaN
goodput) fall back to the raw per-card rate.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

from tpu_hc_bench_torch.resilience import EXIT_CLASSES, classify_exit

__all__ = ["run_one", "score", "parse_stdout_metrics", "EXIT_CLASSES",
           "classify_exit", "build_cmd", "launch_one",
           "kill_process_tree"]


def build_cmd(
    model: str,
    batch: int,
    flags: list[str] | None = None,
    *,
    warmup: int = 25,
    batches: int = 60,
    use_fp16: bool = True,
    workers: int = 0,
) -> list[str]:
    """The launcher command line for one member config (the positional
    ``NUM_HOSTS WORKERS BATCH FABRIC`` contract + tf_cnn-style flags);
    ``workers`` 0 is one worker a card."""
    cmd = [
        sys.executable, "-m", "tpu_hc_bench_torch", "1", str(workers),
        str(batch), "ici",
        f"--model={model}",
        f"--num_warmup_batches={warmup}", f"--num_batches={batches}",
    ]
    if use_fp16:
        cmd.append("--use_fp16=True")
    cmd.extend(flags or [])
    return cmd


def launch_one(cmd: list[str], *, env: dict | None = None,
               cwd: str | None = None, stdout=None,
               stderr=subprocess.STDOUT) -> subprocess.Popen:
    """Start a job subprocess in its OWN session (and so its own
    process group): feeder pools and service grandchildren it spawns
    share the group, and ``kill_process_tree`` can reap the whole tree
    instead of orphaning them past the parent's death."""
    return subprocess.Popen(
        cmd, env=env, cwd=cwd, stdout=stdout, stderr=stderr,
        text=True, start_new_session=True)


def kill_process_tree(proc: subprocess.Popen,
                      sig: int = signal.SIGTERM,
                      grace_s: float = 5.0,
                      escalate: bool = True) -> None:
    """Signal the job's whole process group; with ``escalate`` (the
    timeout path), SIGKILL the group after ``grace_s`` if any member is
    still alive.  ``escalate=False`` sends the one signal and returns
    (a graceful preempt, where the in-job handler needs its grace
    window for the emergency checkpoint).  Safe on an already-dead
    process, and falls back to the single process when the child shares
    our group (a caller that bypassed ``launch_one``)."""
    try:
        pgid = os.getpgid(proc.pid)
    except (ProcessLookupError, OSError):
        pgid = None
    own_group = False
    try:
        own_group = pgid is not None and pgid != os.getpgid(0)
    except OSError:
        pass

    def _send(s: int) -> None:
        try:
            if own_group:
                os.killpg(pgid, s)
            else:
                proc.send_signal(s)
        except (ProcessLookupError, PermissionError, OSError):
            pass

    def _group_alive() -> bool:
        # ANY surviving member counts — the leader exiting while a
        # SIGTERM-ignoring grandchild lives is exactly the orphan (and
        # held-open pipe) this escalation exists to reap
        if own_group:
            try:
                os.killpg(pgid, 0)
                return True
            except (ProcessLookupError, PermissionError, OSError):
                return False
        return proc.poll() is None

    _send(sig)
    if sig == signal.SIGKILL or not escalate:
        return
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        proc.poll()             # reap the leader so its pgid can empty
        if not _group_alive():
            return
        time.sleep(0.05)
    if _group_alive():
        _send(signal.SIGKILL)


def parse_stdout_metrics(out: str) -> dict:
    """The stdout parse: ``images/sec/chip: X  step: Yms (p50/step ...)
    MFU: W% (source)`` (also the ``examples/sec/chip`` spelling)."""
    rec: dict = {}
    for line in out.splitlines():
        if line.startswith("images/sec/chip:") or "examples/sec/chip" in line:
            parts = line.replace("%", "").split()
            try:
                rec["per_chip"] = float(parts[1])
                rec["step_ms"] = float(parts[3].rstrip("ms"))
                rec["mfu_pct"] = float(parts[-2] if parts[-1].startswith("(")
                                       else parts[-1])
            except (IndexError, ValueError):
                pass
    return rec


def _read_summary(metrics_dir: str) -> dict | None:
    """The final ``summary`` record of the run's metrics.jsonl (None
    when the stream is missing or carries no summary)."""
    path = os.path.join(metrics_dir, "metrics.jsonl")
    try:
        summary = None
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("kind") == "summary":
                    summary = rec
        return summary
    except OSError:
        return None


def run_one(
    model: str,
    batch: int,
    flags: list[str] | None = None,
    *,
    warmup: int = 25,
    batches: int = 60,
    timeout_s: float = 1800.0,
    metrics_dir: str | None = None,
    use_fp16: bool = True,
    env: dict | None = None,
    cwd: str | None = None,
) -> dict:
    """Run one member config in a subprocess; return one JSON-able
    record.

    Never raises on a failed run: timeouts, nonzero exits, and
    unparseable output all come back as a record with ``error`` set —
    the search treats those as score-0 candidates.
    """
    flags = list(flags or [])
    if metrics_dir is not None:
        os.makedirs(metrics_dir, exist_ok=True)
        flags.append(f"--metrics_dir={metrics_dir}")
    cmd = build_cmd(model, batch, flags, warmup=warmup, batches=batches,
                    use_fp16=use_fp16)

    rec: dict = {"model": model, "batch_size": batch}
    if flags:
        rec["flags"] = flags
    t0 = time.time()
    proc = launch_one(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                      stderr=subprocess.PIPE)
    try:
        stdout, stderr = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        # reap the WHOLE process group: a timed-out job's feeder pools /
        # service grandchildren must not outlive it (they would starve
        # every later measurement of host CPUs)
        kill_process_tree(proc)
        try:
            # drain pipes; bounded — an unkillable (D-state) survivor
            # holding the pipe must not wedge the whole search
            proc.communicate(timeout=10.0)
        except subprocess.TimeoutExpired:
            pass
        rec.update(wall_s=round(time.time() - t0, 1), error="timeout",
                   exit_class="timeout")
        return rec
    out = stdout + stderr
    rec["wall_s"] = round(time.time() - t0, 1)
    rec["returncode"] = proc.returncode
    if proc.returncode != 0:
        cls = classify_exit(proc.returncode)
        rec["exit_class"] = cls
        rec["error"] = (EXIT_CLASSES.get(proc.returncode)
                        or (out.strip().splitlines()[-1] if out.strip()
                            else "?"))
        return rec
    rec.update(parse_stdout_metrics(out))
    if metrics_dir is not None:
        summary = _read_summary(metrics_dir)
        if summary is not None:
            rec["per_chip"] = summary.get("images_per_sec_per_chip",
                                          rec.get("per_chip"))
            rec["step_ms"] = summary.get("mean_step_ms",
                                         rec.get("step_ms"))
            mfu = summary.get("mfu")
            if mfu is not None:
                rec["mfu_pct"] = round(100.0 * mfu, 2)
            gp = summary.get("goodput")
            # NaN goodput (no ledger) serializes as "NaN"/null — keep
            # only a real fraction
            if isinstance(gp, (int, float)) and gp == gp:
                rec["goodput"] = round(gp, 4)
            # measured device memory (obs.memory): the run's high water
            # and the card's memory ride the journal so the pruner's
            # known-OOM model can anchor on MEASUREMENT instead of the
            # seeded guess (hbm_source=measured)
            if summary.get("peak_hbm_bytes"):
                rec["peak_hbm_bytes"] = int(summary["peak_hbm_bytes"])
                rec["mem_source"] = summary.get("mem_source")
            if summary.get("hbm_bytes_limit"):
                rec["hbm_bytes_limit"] = int(summary["hbm_bytes_limit"])
    if "per_chip" not in rec:
        rec["error"] = "no-throughput-line"
    return rec


def score(rec: dict) -> float:
    """Goodput-adjusted per-card throughput (the search objective).
    Failed runs score 0."""
    if rec.get("error"):
        return 0.0
    per_chip = rec.get("per_chip") or 0.0
    gp = rec.get("goodput")
    if isinstance(gp, (int, float)) and gp == gp and gp > 0:
        return per_chip * gp
    return per_chip
