"""The port's shared host input service (``tpu_hc_bench_torch.data.service``)
against the JAX package's, on the CPU; the cases of
``tests/test_input_service.py`` that test this module:

- **the ring**: concurrent handoff in order and intact, the stall and
  occupancy counters, error and close signalling, a missing segment and
  a disagreeing layout refused, ``stop()`` releasing a blocked consumer,
  a feeder's error reaching the consumer; the occupancy percentiles
  equal JAX's on random histograms;
- **the streams**: each worker's ring stream bit-equal to JAX's
  ``ImageNetDataset`` stream (``_batches``), uint8 and float32, full and
  sliced (``slice_per_worker``: only the worker's rows), and to the
  port's per-process pipeline; the default pool width JAX's;
- **mixing**: ``mixture_schedule`` equal to JAX's, ``weighted_mixture``
  following it, a two-source image service reproducible;
- **packing**: ``split_documents``, ``pack_sequences`` and
  ``PackedTokenDataset`` equal to JAX's, and the packed-token service
  delivering JAX's batches;
- **the owner's processes** (``ServiceProcess``, what the driver starts):
  two processes' rings bit-equal to JAX's stream, their account, their
  stop, and a start that fails raising;
- **flags and the driver**: ``--input_service`` and
  ``--service_decode_workers`` parse, JAX's translations of ``on`` to
  ``off``, ``_input_service_on``'s rule; and the launcher at four gloo
  ranks on the fixture (the narrow ResNet standing in for resnet50 at
  32x32), ``auto`` engaging the service, ending bit-equal to
  ``--input_service=off``.

Ring names here start ``thbpt`` (the JAX tests' ``thbt``) and end in
this process's id and a random tag (``_shm``): the two files, and two
checkouts' copies of this one, may run at once.  JAX is imported inside the test functions only: the
launcher's ranks run this file and import nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_hc_bench_torch import flags
from tpu_hc_bench_torch.data import imagenet, tokens
from tpu_hc_bench_torch.data import service as svc
from tpu_hc_bench_torch.parallel import distributed
from tpu_hc_bench_torch.train import driver
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tpu_hc_bench_torch" / "data" / "testdata" / "imagenet_tiny"
LAUNCH_WORLD = 4
# each run's rings have names of their own: segments live in one
# namespace per machine, and creating a ring reclaims a segment of the
# same name as a crashed run's
_RUN = f"{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _shm(tag: str) -> str:
    return f"thbpt_{tag}_{_RUN}"


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("svc_shards")
    imagenet.make_synthetic_shards(
        d, num_shards=4, examples_per_shard=6, image_size=32,
        num_classes=10)
    return d


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("svc_corpus")
    rng = np.random.default_rng(0)
    stream: list[int] = []
    while len(stream) < 6000:
        stream.extend(rng.integers(1, 90, int(rng.integers(3, 40))).tolist()
                      + [0])
    tokens.write_token_file(d / "train.bin", np.asarray(stream),
                            vocab_size=90)
    return d


# --- the ring ----------------------------------------------------------------


def _layout():
    return svc.BatchLayout([svc.ArraySpec("img", (4, 8), "uint8"),
                            svc.ArraySpec("lab", (4,), "int32")])


def test_layouts_are_jax_s():
    from tpu_hc_bench.data import service as jax_svc

    for mine, theirs in ((svc.image_batch_layout(8, 24, "uint8"),
                          jax_svc.image_batch_layout(8, 24, "uint8")),
                         (svc.image_batch_layout(3, 16, "float32"),
                          jax_svc.image_batch_layout(3, 16, "float32")),
                         (svc.packed_token_layout(4, 33),
                          jax_svc.packed_token_layout(4, 33))):
        assert mine.offsets == theirs.offsets
        assert mine.slot_nbytes == theirs.slot_nbytes
        assert [dataclasses.astuple(a) for a in mine.arrays] == \
            [dataclasses.astuple(a) for a in theirs.arrays]
    assert svc.service_name("a", 1, True) == jax_svc.service_name(
        "a", 1, True)
    assert svc.ShmRing._size(_layout(), 3) == \
        jax_svc.ShmRing._size(_layout(), 3)


def test_ring_concurrent_handoff_order_and_integrity():
    lay = _layout()
    ring = svc.ShmRing.create(_shm("ring1"), lay, 2)
    try:
        peer = svc.ShmRing.attach(_shm("ring1"), lay, 2)
        n = 60

        def produce():
            for i in range(n):
                ring.put((np.full((4, 8), i % 251, np.uint8),
                          np.full((4,), i, np.int32)))
            ring.close_producer()

        t = threading.Thread(target=produce)
        t.start()
        seen = []
        while True:
            views = peer.get(timeout=30.0)
            if views is None:
                break
            img, lab = views
            i = int(lab[0])
            assert (img == i % 251).all()
            seen.append(i)
            if i % 7 == 0:
                time.sleep(0.002)
            peer.advance()
        t.join()
        assert seen == list(range(n))
        s = ring.stats()
        assert s["produced"] == s["consumed"] == n
        assert sum(s["occ_hist"]) == n
        assert s["producer_stall_s"] > 0.0
        assert 0 <= s["occ_p50"] <= s["occ_p99"] <= 2
        peer.close()
    finally:
        ring.close()
        ring.unlink()


def test_occupancy_percentiles_are_jax_s():
    from tpu_hc_bench.data import service as jax_svc

    rng = np.random.default_rng(0)
    for _ in range(500):
        depth = int(rng.integers(1, 9))
        hist = [int(x) for x in rng.integers(0, 6, depth + 1)
                * (rng.random(depth + 1) < 0.6)]
        for q in (0.5, 0.99):
            assert svc._hist_percentile(hist, q) == \
                jax_svc._hist_percentile(hist, q), (hist, q)


def test_ring_error_and_close_signalling():
    ring = svc.ShmRing.create(_shm("ring2"), _layout(), 2)
    try:
        ring.close_producer(error=True)
        with pytest.raises(RuntimeError, match="producer died"):
            ring.get()
    finally:
        ring.close()
        ring.unlink()


def test_ring_attach_missing_times_out():
    with pytest.raises(FileNotFoundError, match="did not appear"):
        svc.ShmRing.attach(_shm("never_exists"), _layout(), 2, timeout=0.2)


def test_ring_layout_mismatch_rejected():
    small = _layout()
    big = svc.BatchLayout([svc.ArraySpec("img", (64, 64, 64, 3), "uint8")])
    ring = svc.ShmRing.create(_shm("ring3"), small, 6)
    try:
        with pytest.raises(ValueError, match="disagree"):
            svc.ShmRing.attach(_shm("ring3"), big, 6, timeout=1.0)
        with pytest.raises(ValueError, match="geometry"):
            svc.ShmRing.attach(_shm("ring3"), small, 2, timeout=1.0)
        with pytest.raises(ValueError, match="layout expects"):
            ring.put((np.zeros((4, 8), np.uint8),))
    finally:
        ring.close()
        ring.unlink()


def test_service_stop_unblocks_waiting_consumer(shards):
    service = svc.make_image_service(
        [str(shards)], num_workers=1, global_batch=4, image_size=16,
        depth=2, name=_shm("stop")).start()
    client = svc.ServiceClient(service.name,
                               svc.image_batch_layout(4, 16, "uint8"),
                               worker=0, copy=True)
    it = iter(client)
    next(it)
    got = {}

    def drain():
        got["n"] = sum(1 for _ in it)

    t = threading.Thread(target=drain)
    t.start()
    time.sleep(0.05)
    service.stop()
    t.join(timeout=10.0)
    assert not t.is_alive(), "consumer still blocked after service.stop()"
    client.close()


def test_feeder_error_reaches_consumer():
    def bad_stream(w):
        def gen():
            raise RuntimeError("boom")
            yield  # pragma: no cover
        return gen()

    lay = _layout()
    service = svc.InputService(_shm("err"), lay, 1, bad_stream,
                               depth=2).start()
    try:
        client = svc.ServiceClient(_shm("err"), lay, worker=0)
        with pytest.raises(RuntimeError, match="producer died"):
            next(iter(client))
        assert service.errors and "boom" in service.errors[0]
        client.close()
    finally:
        service.stop()


# --- the streams: the service against JAX's pipeline -------------------------


def _jax_stream(shards, worker, num_workers, n, seed=7, wire="uint8"):
    """JAX's per-process stream, which the service must deliver."""
    from tpu_hc_bench.data import imagenet as jax_imagenet

    it = jax_imagenet.ImageNetDataset(
        shards, global_batch=4, image_size=16, train=True, worker=worker,
        num_workers=num_workers, seed=seed, wire_dtype=wire)._batches()
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def _ring_batches(service, worker, batch, n, wire="uint8"):
    client = svc.ServiceClient(
        service.name, svc.image_batch_layout(batch, 16, wire),
        worker=worker, copy=True)
    it = iter(client)
    out = [next(it) for _ in range(n)]
    client.close()
    return out


@pytest.mark.parametrize("wire", ["uint8", "float32"])
def test_service_stream_is_jax_s_bitwise(shards, wire):
    """Each worker's ring stream is JAX's ``ImageNetDataset`` stream of
    that worker, and the port's own per-process stream, bit for bit."""
    service = svc.make_image_service(
        [str(shards)], num_workers=2, global_batch=4, image_size=16,
        seed=7, wire_dtype=wire, depth=2, name=_shm(f"id_{wire}")).start()
    try:
        for w in range(2):
            want = _jax_stream(shards, w, 2, 3, wire=wire)
            mine = imagenet.ImageNetDataset(
                shards, global_batch=4, image_size=16, train=True, worker=w,
                num_workers=2, seed=7, wire_dtype=wire)._batches()
            for n, (img, lab) in enumerate(_ring_batches(service, w, 4, 3,
                                                         wire)):
                assert img.dtype == np.dtype(wire)
                np.testing.assert_array_equal(img, want[n][0])
                np.testing.assert_array_equal(lab, want[n][1])
                own = next(mine)
                np.testing.assert_array_equal(img, own[0])
            mine.close()
    finally:
        service.stop()


def test_sliced_rings_carry_the_worker_rows_of_jax_s_stream(shards):
    service = svc.make_image_service(
        [str(shards)], num_workers=2, global_batch=4, image_size=16,
        seed=7, wire_dtype="uint8", depth=2, slice_per_worker=True,
        name=_shm("sliced")).start()
    try:
        for w in range(2):
            want = _jax_stream(shards, w, 2, 2)
            lo, hi = w * 2, (w + 1) * 2
            for n, (img, lab) in enumerate(_ring_batches(service, w, 2, 2)):
                np.testing.assert_array_equal(img, want[n][0][lo:hi])
                np.testing.assert_array_equal(lab, want[n][1][lo:hi])
        with pytest.raises(ValueError, match="divisible"):
            svc.make_image_service([str(shards)], num_workers=3,
                                   global_batch=4, image_size=16,
                                   slice_per_worker=True)
    finally:
        service.stop()


def test_service_process_serves_jax_s_stream_and_stops(shards):
    """The owner in two processes of its own (what the driver starts,
    one a worker): each worker's sliced ring bit-equal to JAX's stream
    rows, the account read from the rings' headers, and ``stop()``
    ending the processes and their segments."""
    spec = dict(data_dirs=[str(shards)], num_workers=2, global_batch=4,
                image_size=16, seed=7, wire_dtype="uint8", depth=2,
                decode_workers=4, name=_shm("proc"), slice_per_worker=True)
    proc = svc.ServiceProcess(spec)
    try:
        assert proc.decode_workers == 4
        assert [p.poll() for p in proc.procs] == [None, None]
        for w in range(2):
            want = _jax_stream(shards, w, 2, 2)
            lo, hi = w * 2, (w + 1) * 2
            for n, (img, lab) in enumerate(_ring_batches(proc, w, 2, 2)):
                np.testing.assert_array_equal(img, want[n][0][lo:hi])
                np.testing.assert_array_equal(lab, want[n][1][lo:hi])
        st = proc.stats()
        assert st["workers"] == 2 and st["errors"] == 0
        assert st["consumed"] == 4 and st["produced"] >= 4
    finally:
        proc.stop()
    assert [p.returncode for p in proc.procs] == [0, 0]
    with pytest.raises(FileNotFoundError):
        svc.ShmRing.attach(f"{spec['name']}-w0", svc.image_batch_layout(
            2, 16, "uint8"), 2, timeout=0.2)


def test_service_process_errors_reach_the_caller(shards, tmp_path):
    """A spec the service refuses ends the process before it is ready:
    ``ServiceProcess`` raises; a stream that fails in the process closes
    its ring on an error, which the client raises and the account
    counts."""
    bad = dict(data_dirs=[str(shards)], num_workers=3, global_batch=4,
               image_size=16, depth=2, name=_shm("bad"),
               slice_per_worker=True)
    with pytest.raises(RuntimeError, match="did not come up"):
        svc.ServiceProcess(bad, timeout=60.0)
    proc = svc.ServiceProcess(dict(
        data_dirs=[str(tmp_path / "none")], num_workers=1, global_batch=4,
        image_size=16, depth=2, name=_shm("nodata")))
    try:
        client = svc.ServiceClient(proc.name, svc.image_batch_layout(
            4, 16, "uint8"), worker=0)
        with pytest.raises(RuntimeError, match="producer died"):
            next(iter(client))
        client.close()
        assert proc.stats()["errors"] == 1
    finally:
        proc.stop()


def test_default_pool_width_is_jax_s():
    from tpu_hc_bench.data import service as jax_svc

    assert svc.default_service_pool_width() == \
        jax_svc.default_service_pool_width()


def test_service_backpressure_stats(shards):
    service = svc.make_image_service(
        [str(shards)], num_workers=1, global_batch=4, image_size=16,
        seed=0, depth=2, decode_workers=2, name=_shm("bp")).start()
    try:
        client = svc.ServiceClient(
            service.name, svc.image_batch_layout(4, 16, "uint8"),
            worker=0, copy=True)
        it = iter(client)
        next(it)
        time.sleep(0.3)             # the ring fills: the producer stalls
        next(it)
        s = service.stats()
        assert s["workers"] == 1 and s["depth"] == 2
        assert s["decode_workers"] == 2
        assert s["produced"] >= 2 and s["errors"] == 0
        assert s["producer_stall_s"] > 0.0
        assert set(s) >= {"occ_p50", "occ_p99", "consumer_wait_s"}
        assert set(client.window_stats()) == {"ring_occ", "ring_depth",
                                              "wait_ms"}
        cstats = client.stats()
        assert cstats["input_service"] is True
        assert cstats["examples"] == cstats["batches"] * 4 == 8
        client.close()
    finally:
        service.stop()


# --- mixing ------------------------------------------------------------------


def test_mixture_schedule_is_jax_s():
    from tpu_hc_bench.data import service as jax_svc

    for weights, seed in (([3.0, 1.0], 5), ([0.2, 0.3, 0.5], (2, 1))):
        np.testing.assert_array_equal(
            svc.mixture_schedule(weights, seed=seed, n=200),
            jax_svc.mixture_schedule(weights, seed=seed, n=200))
    frac = float((svc.mixture_schedule([3.0, 1.0], 5, 400) == 0).mean())
    assert 0.6 < frac < 0.9
    with pytest.raises(ValueError, match="weights"):
        svc.mixture_schedule([0.0, 0.0], seed=0, n=4)
    with pytest.raises(ValueError, match="streams"):
        svc.weighted_mixture([iter(())], [0.5, 0.5])


def test_weighted_mixture_follows_schedule():
    import itertools

    streams = [iter(("a", i) for i in itertools.count()),
               iter(("b", i) for i in itertools.count())]
    mix = svc.weighted_mixture(streams, [0.5, 0.5], seed=11)
    got = [next(mix)[0] for _ in range(32)]
    sched = svc.mixture_schedule([0.5, 0.5], seed=11, n=32)
    assert got == ["ab"[i] for i in sched]


def test_image_mixture_service_is_reproducible(shards, tmp_path):
    other = tmp_path / "other"
    imagenet.make_synthetic_shards(other, num_shards=2,
                                   examples_per_shard=6, image_size=32,
                                   num_classes=10, seed=3)

    def grab(tag):
        service = svc.make_image_service(
            [str(shards), str(other)], mix_weights=[0.5, 0.5],
            num_workers=1, global_batch=4, image_size=16, seed=2,
            depth=2, name=_shm(f"mix{tag}")).start()
        try:
            return _ring_batches(service, 0, 4, 4)
        finally:
            service.stop()

    for (i1, l1), (i2, l2) in zip(grab(1), grab(2)):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(l1, l2)


# --- packing -----------------------------------------------------------------


def test_split_and_pack_are_jax_s():
    from tpu_hc_bench.data import tokens as jax_tokens

    rng = np.random.default_rng(4)
    for _ in range(20):
        stream = rng.integers(0, 6, int(rng.integers(1, 120)))
        docs = tokens.split_documents(stream, eod_id=0)
        want = jax_tokens.split_documents(stream, eod_id=0)
        assert [d.tolist() for d in docs] == [d.tolist() for d in want]
        for seq_len in (1, 5, 16):
            got = tokens.pack_sequences(docs, seq_len)
            ref = jax_tokens.pack_sequences(want, seq_len)
            assert got.keys() == ref.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert [d.tolist() for d in tokens.split_documents(
        np.array([5, 6, 0, 0, 7, 0, 8, 9]), eod_id=0)] == \
        [[5, 6, 0], [7, 0], [8, 9]]
    with pytest.raises(ValueError, match="seq_len"):
        tokens.pack_sequences([], 0)


def test_packed_dataset_is_jax_s(corpus):
    from tpu_hc_bench.data import tokens as jax_tokens

    for kw in (dict(global_batch=8, seq_len=32, seed=1),
               dict(global_batch=4, seq_len=16, seed=4, worker=1,
                    num_workers=2)):
        mine = tokens.PackedTokenDataset(corpus, eod_id=0, **kw)
        ref = jax_tokens.PackedTokenDataset(corpus, eod_id=0, **kw)
        for step in range(3):
            got, want = mine.batch(step), ref.batch(step)
            assert len(got) == 4
            for a, b in zip(got, want):
                assert a.shape == (kw["global_batch"], kw["seq_len"])
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_packed_token_service_delivers_jax_s_batches(corpus):
    from tpu_hc_bench.data import tokens as jax_tokens

    ref = jax_tokens.PackedTokenDataset(corpus, global_batch=4, seq_len=16,
                                        eod_id=0, seed=4)
    service = svc.make_packed_token_service(
        str(corpus), num_workers=1, global_batch=4, seq_len=16, eod_id=0,
        seed=4, depth=2, name=_shm("packed")).start()
    try:
        client = svc.ServiceClient(service.name,
                                   svc.packed_token_layout(4, 16), worker=0,
                                   copy=True)
        it = iter(client)
        for n in range(2):
            for a, b in zip(next(it), ref.batch(n)):
                np.testing.assert_array_equal(a, b)
        client.close()
    finally:
        service.stop()


# --- flags and the driver ---------------------------------------------------


@pytest.mark.parametrize("argv,off", [
    (["--input_service=on"], "synthetic input"),
    (["--input_service=on", "--model=gpt2", "--data_dir=D"], "text members"),
    (["--input_service=on", "--data_dir=D",
      "--datasets_repeat_cached_sample=true"], "repeat_cached_sample"),
    (["--input_service=on", "--data_dir=D", "--eval=true"], "--eval"),
    (["--input_service=on", "--data_dir=D"], None),
])
def test_input_service_translations_are_jax_s(shards, argv, off):
    from tpu_hc_bench import flags as jax_flags

    argv = [a.replace("=D", f"={shards}") for a in argv]
    mine = flags.parse_benchmark_flags(["--device=cpu"] + argv)
    jax_cfg = jax_flags.parse_flags(argv)
    assert mine.input_service == jax_cfg.input_service
    if off is None:
        assert mine.input_service == "on"
        assert "input_service" not in mine.translations
    else:
        assert mine.input_service == "off"
        assert off in mine.translations["input_service"]
        assert mine.translations["input_service"] == \
            jax_cfg.translations["input_service"]


def test_service_flags_parse_and_refuse():
    cfg = flags.parse_benchmark_flags(["--device=cpu",
                                       "--service_decode_workers=3"])
    assert cfg.service_decode_workers == 3 and cfg.input_service == "auto"
    assert "service_decode_workers" not in flags.LATER_SLICE_TRAIN_FLAGS
    with pytest.raises(ValueError, match="service_decode_workers"):
        flags.BenchmarkConfig(service_decode_workers=-1).resolve()
    with pytest.raises(ValueError, match="on|off|auto"):
        flags.BenchmarkConfig(input_service="sometimes").resolve()


def test_input_service_on_rule():
    def on(mode, world, local, **kw):
        cfg = flags.BenchmarkConfig(device="cpu", input_service=mode,
                                    data_dir="d", **kw)
        return driver._input_service_on(cfg, world, local)

    assert on("auto", 4, 4) and not on("auto", 1, 1)
    assert not on("auto", 8, 4)                     # two hosts
    assert on("on", 1, 1) and on("on", 4, 4)
    with pytest.raises(ValueError, match="one host"):
        on("on", 8, 4)
    assert not on("off", 4, 4)
    assert not on("auto", 4, 4, eval=True)
    assert not on("auto", 4, 4, datasets_repeat_cached_sample=True)


# --- the launcher at four ranks ----------------------------------------------


def _narrow_create(name, dtype, attention_impl, *, device, seed, rank, **kw):
    """resnet50 replaced by the narrow ResNet at 32x32 with ImageNet's
    1000 classes (the fixture's labels)."""
    from tpu_hc_bench_torch.models import get_model_spec, resnet

    model = resnet.ResNet([1, 1, 1, 1], resnet.BottleneckBlock,
                          fused_conv=kw["fused_conv"], num_classes=1000,
                          num_filters=8)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)
    return model.train(), dataclasses.replace(get_model_spec(name),
                                              input_shape=(32, 32, 3))


def _launch_worker() -> int:
    """A spawned rank: the launcher's own worker path with the narrow
    ResNet (no JAX here)."""
    assert "jax" not in sys.modules and "tpu_hc_bench" not in sys.modules
    from tpu_hc_bench_torch import launcher

    driver.create_model = _narrow_create
    return launcher.main(sys.argv[2:])


@pytest.mark.parametrize("sliced", [True, False])
def test_four_ranks_auto_engages_the_service_bit_equal_to_off(
        tmp_path, sliced):
    """``1 4 2 ib --model=resnet50 --device=cpu --data_dir=<fixture>``
    (each rank this file as a worker: the narrow ResNet at 32x32), with
    ``--input_service=auto`` and ``off``: auto engages the service (the
    decode-pool line names it, the result says so) and the final
    parameters are bit-equal to off's."""
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    results = {}
    for mode in ("auto", "off"):
        argv = ["1", str(LAUNCH_WORLD), "2", "ib", "--model=resnet50",
                "--device=cpu", f"--data_dir={FIXTURE}",
                "--num_warmup_batches=1", "--num_batches=2",
                f"--input_service={mode}",
                f"--full_batch_identity={not sliced}",
                f"--train_dir={tmp_path / mode}"]
        workers = [distributed.Worker(r, r, LAUNCH_WORLD,
                                      f"file://{tmp_path}/{mode}_store")
                   for r in range(LAUNCH_WORLD)]
        lines: list[str] = []
        rc = distributed.spawn_local(
            [sys.executable, str(Path(__file__).resolve()), "--launch",
             *argv], workers, lines.append)
        assert rc == 0, lines[-10:]
        results[mode] = (lines, json.loads(
            [ln for ln in lines if ln.startswith("{")][-1]))
    lines, res = results["auto"]
    assert res["data"]["input_service"] is True
    assert res["data"]["service"]["workers"] == LAUNCH_WORLD
    assert res["data"]["service"]["errors"] == 0
    assert res["data"]["batches"] >= 3          # 1 warmup + 2 timed
    assert any(ln.startswith("decode pool: input service thbsvc")
               and f"in {LAUNCH_WORLD} process(es) of its own" in ln
               for ln in lines)
    assert (res["data"]["sliced_rows"] is not None) == sliced
    off = results["off"][1]
    assert off["data"]["input_service"] is False
    assert res["checkpoint"]["fingerprint"] == off["checkpoint"]["fingerprint"]
    got = ckpt.load_payload(tmp_path / "auto")[1]["model"]
    want = ckpt.load_payload(tmp_path / "off")[1]["model"]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert res["final_loss"] == off["final_loss"]


if __name__ == "__main__" and sys.argv[1:2] == ["--launch"]:
    sys.exit(_launch_worker())
