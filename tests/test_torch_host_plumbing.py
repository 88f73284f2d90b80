"""The launcher's host plumbing in the port against the JAX package's, on
the CPU: the env registry (``tpu_hc_bench_torch/envfile.py``), the
per-run log (``train/driver.log_name`` and the launcher's ``finally``),
``FabricConfig.env_exports`` and the corpus writer (``python -m
tpu_hc_bench_torch.data.tokens``).

- the registry file is JAX's byte for byte for the same ``register``
  calls (a block replaced in place, others kept), and ``sh`` sources it;
- a value with a backslash survives a re-register (JAX's ``re.sub``
  reads its replacement as a template: ``\\p`` raises there, ``\\1``
  would be read as a group);
- ``log_name`` and the fabric's exports equal JAX's;
- the launcher writes its log and its ``launcher`` block under a
  temporary ``HOME`` for a ``--device=cpu`` run, a preempted one (exit
  75) too, and only the first host's launcher does;
- the corpus CLI writes files byte-identical to JAX's CLI for the same
  ``--seed``/``--num_tokens``, and for ``--from_text``.
"""

from __future__ import annotations

import json
import re
import subprocess

import numpy as np
import pytest

from tpu_hc_bench import envfile as jax_envfile
from tpu_hc_bench.data import tokens as jax_tokens
from tpu_hc_bench.parallel import fabric as jax_fabric
from tpu_hc_bench.train import driver as jax_driver
from tpu_hc_bench_torch import envfile, launcher
from tpu_hc_bench_torch.data import tokens
from tpu_hc_bench_torch.parallel import fabric
from tpu_hc_bench_torch.train import driver
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REGISTRATIONS = (
    ("jax", {"TPU_HC_BENCH_FABRIC": "ici"}),
    ("data", {"TPU_HC_BENCH_DATA_DIR": "/mnt/data",
              "MY_VAR": "hello world", "Q": "it's"}),
    ("jax", {"TPU_HC_BENCH_FABRIC": "host", "A": "2"}),
    ("launcher", {"TPU_HC_BENCH_FUSION_THRESHOLD": "134217728"}),
    ("data", {"TPU_HC_BENCH_DATA_DIR": "/other"}),
)


@pytest.mark.parametrize("n", range(1, len(REGISTRATIONS) + 1))
def test_registry_file_is_jax_byte_for_byte(tmp_path, n):
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    for tag, exports in REGISTRATIONS[:n]:
        envfile.register(tag, exports, path=mine)
        jax_envfile.register(tag, exports, path=ref)
    assert mine.read_bytes() == ref.read_bytes()
    assert envfile.read(mine) == jax_envfile.read(ref)
    # a tag re-registered is replaced, never duplicated
    assert mine.read_text().count("# >>> tpu_hc_bench:jax >>>") == 1


def test_registry_is_sourceable_by_sh(tmp_path):
    p = tmp_path / "setenv"
    envfile.register("t", {"MY_VAR": "hello world", "Q": "it's"}, path=p)
    out = subprocess.run(
        ["sh", "-c", f". {p} && printf '%s|%s' \"$MY_VAR\" \"$Q\""],
        capture_output=True, text=True, check=True)
    assert out.stdout == "hello world|it's"


def test_registry_keeps_a_backslash_on_replace(tmp_path):
    p = tmp_path / "setenv"
    envfile.register("w", {"P": "C:\\path\\1"}, path=p)
    envfile.register("w", {"P": "D:\\path\\1"}, path=p)
    assert envfile.read(p)["P"] == "D:\\path\\1"
    # JAX's replacement reads the block as a template
    q = tmp_path / "jax"
    jax_envfile.register("w", {"P": "C:\\path"}, path=q)
    with pytest.raises(re.error):
        jax_envfile.register("w", {"P": "D:\\path"}, path=q)


def test_registry_default_path_follows_the_environment(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "h"))
    monkeypatch.delenv(envfile.SETENV_ENV, raising=False)
    assert envfile.default_path() == tmp_path / "h" / ".tpu_hc_bench" / \
        "setenv"
    monkeypatch.setenv(envfile.SETENV_ENV, str(tmp_path / "s"))
    envfile.register("t", {"A": "1"})
    assert envfile.read() == {"A": "1"}
    assert envfile.read(tmp_path / "missing") == {}


@pytest.mark.parametrize("args", [(1, 64, "synthetic", "ici"),
                                  (2, 128, "real", "host"),
                                  (4, 8, "synthetic", "dcn", 3)])
def test_log_name_equals_jax(args):
    assert driver.log_name(*args) == jax_driver.log_name(*args)


@pytest.mark.parametrize("name", ["ib", "sock", "dcn"])
def test_fabric_exports_equal_jax(name):
    mine = fabric.FabricConfig(fabric.resolve_fabric(name), 1 << 20)
    ref = jax_fabric.FabricConfig(jax_fabric.resolve_fabric(name), 1 << 20)
    assert mine.env_exports() == ref.env_exports()


def _launch(monkeypatch, tmp_path, argv, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv(envfile.SETENV_ENV, raising=False)
    lines: list[str] = []
    rc = launcher.main(argv, print_fn=lines.append)
    return rc, lines, capsys.readouterr().out


def test_launcher_writes_log_and_registry(tmp_path, monkeypatch, capsys):
    rc, lines, out = _launch(
        monkeypatch, tmp_path,
        ["1", "1", "2", "sock", "--model=trivial", "--device=cpu",
         "--num_classes=10", "--num_warmup_batches=1", "--num_batches=2",
         "--fusion_threshold_bytes=4096"], capsys)
    assert rc == 0
    log = tmp_path / "logs" / "tpubench-1n-2b-synthetic-host-r1.log"
    assert out.splitlines()[-1] == f"log: {log}"
    assert log.read_text() == "\n".join(lines) + "\n"
    assert lines[0].startswith("command: python -m tpu_hc_bench_torch 1 1")
    assert json.loads(lines[-1])["model"] == "trivial"
    assert envfile.read(tmp_path / ".tpu_hc_bench" / "setenv") == {
        "TPU_HC_BENCH_FABRIC": "host",
        "TPU_HC_BENCH_FUSION_THRESHOLD": "4096"}


def test_launcher_writes_log_of_a_preempted_run(tmp_path, monkeypatch,
                                                capsys):
    rc, lines, out = _launch(
        monkeypatch, tmp_path,
        ["1", "1", "2", "ib", "--model=trivial", "--device=cpu",
         "--num_classes=10", "--num_warmup_batches=1", "--num_batches=6",
         f"--train_dir={tmp_path / 'ck'}", "--inject_fault=sigterm@2"],
        capsys)
    assert rc == 75
    log = tmp_path / "logs" / "tpubench-1n-2b-synthetic-ici-r1.log"
    text = log.read_text()
    assert "emergency checkpoint saved" in text
    assert "state fingerprint:" in text
    assert out.splitlines()[-1] == f"log: {log}"


def test_launcher_log_survives_a_read_only_home(tmp_path, monkeypatch,
                                                capsys):
    home = tmp_path / "ro"
    home.mkdir()
    (home / "logs").write_text("a file where the directory would be")
    (home / ".tpu_hc_bench").write_text("likewise")
    rc, lines, out = _launch(
        monkeypatch, home,
        ["1", "1", "2", "sock", "--model=trivial", "--device=cpu",
         "--num_classes=10", "--num_warmup_batches=1", "--num_batches=1"],
        capsys)
    assert rc == 0 and "log:" not in out
    assert json.loads(lines[-1])["model"] == "trivial"


def test_only_the_first_host_writes(tmp_path, monkeypatch, capsys):
    """A spawned worker (and a host other than the first) never writes
    the log or the registry: its lines reach the first host's launcher,
    which does."""
    from tpu_hc_bench_torch.parallel import distributed

    calls = []
    monkeypatch.setattr(launcher, "_register_env",
                        lambda *a: calls.append("register"))
    monkeypatch.setattr(distributed, "multi_host_store",
                        lambda n: (1, "tcp://h0:1"))
    monkeypatch.setattr(distributed, "spawn_local",
                        lambda cmd, workers, tee: calls.append(
                            [w.rank for w in workers]) or 0)
    rc, _, out = _launch(
        monkeypatch, tmp_path,
        ["2", "2", "2", "ib", "--model=trivial", "--device=cpu"], capsys)
    assert rc == 0 and calls == [[2, 3]]
    assert "log:" not in out and not (tmp_path / "logs").exists()


@pytest.mark.parametrize("argv", [["--seed", "3", "--num_tokens", "5000"],
                                  ["--seed", "0", "--num_tokens", "777",
                                   "--vocab_size", "70000",
                                   "--split", "val"]])
def test_corpus_cli_equals_jax(tmp_path, argv, capsys):
    assert tokens.main([str(tmp_path / "mine"), *argv]) == 0
    assert jax_tokens.main([str(tmp_path / "ref"), *argv]) == 0
    split = argv[argv.index("--split") + 1] if "--split" in argv \
        else "train"
    for suffix in (".bin", ".bin.meta.json"):
        assert (tmp_path / "mine" / f"{split}{suffix}").read_bytes() == \
            (tmp_path / "ref" / f"{split}{suffix}").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(":", 1)[1] == out[1].split(":", 1)[1]


def test_corpus_cli_from_text_equals_jax(tmp_path, capsys):
    src = tmp_path / "corpus.txt"
    src.write_text("The fleet trains on bytes. Ünïcödé too.\n" * 50)
    assert tokens.main([str(tmp_path / "mine"), "--from_text",
                        str(src)]) == 0
    assert jax_tokens.main([str(tmp_path / "ref"), "--from_text",
                            str(src)]) == 0
    mine = (tmp_path / "mine" / "train.bin").read_bytes()
    assert mine == (tmp_path / "ref" / "train.bin").read_bytes()
    ds = tokens.TokenDataset(str(tmp_path / "mine"), seq_len=16,
                             global_batch=2)
    assert np.asarray(ds._data[:3]).tolist() == list(src.read_bytes()[:3])
    with pytest.raises(SystemExit):
        tokens.main([str(tmp_path / "x"), "--from_text", str(src),
                     "--seed", "4"])
