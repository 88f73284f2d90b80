"""The port's real-data input against the JAX package's, on the CPU.

- **codec**: CRC32C, TFRecord framing and ``tf.train.Example`` bytes
  equal to JAX's ``data/tfrecord.py`` on the same inputs; the native
  scanner (``tpu_hc_bench_torch.native``, built here by g++) equal to
  the pure-Python reader; truncation and corruption detected by both.
- **dataset**: the port's ``ImageNetDataset`` delivers JAX's uint8 (and
  float32) batches bit for bit: train and eval crops, decode pools of
  width 1 and 4, two ranks' sliced rows, the full-batch identity arm;
  both decode with the same libjpeg, so the tolerance is 0.  The PIL
  route and its count.  The committed fixture's expected crops are
  regenerated with the JAX pipeline and must equal the file.
- **the pil decoder** (PIL's libjpeg-turbo, DCT-scaled by
  ``Image.draft``, then ``crop_resize.cpp``), forced by name: the
  fixture's expected crops bit for bit, libjpeg's crops bit for bit at
  DCT scales 1, 2, 4 and 8, the PNG and CMYK streams to the PIL route,
  and ``jpeg_decoder()``'s order: libjpeg, then pil, then nvJPEG.
- **tokens**: ``TokenDataset`` windows equal to JAX's, causal and MLM,
  one worker and two.
- **feed**: ``DeviceFeeder`` on the CPU hands out the model's layouts.

``python tests/test_torch_data.py DIR`` rewrites the fixture into DIR:
the shards by the port's ``make_synthetic_shards`` (needs PIL), the
expected crops by the JAX pipeline.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_hc_bench.data import imagenet as jax_imagenet
from tpu_hc_bench.data import tfrecord as jax_tfrecord
from tpu_hc_bench.data import tokens as jax_tokens
from tpu_hc_bench_torch import native
from tpu_hc_bench_torch.data import imagenet, tfrecord, tokens
from tpu_hc_bench_torch.data.feed import DeviceFeeder
from torch_threads import cpu_share, jax_private_cache  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tpu_hc_bench_torch" / "data" / "testdata" / "imagenet_tiny"
FIXTURE_SIZE = 64                      # the expected crops' image size
FIXTURE_BATCH = 16


# --- the fixture ------------------------------------------------------------


def jax_expected_crops(data_dir: Path) -> dict[str, np.ndarray]:
    """The JAX pipeline's uint8 output at seed 0 and size 64: two train
    batches of 16 and one eval batch of 16 (the validation split)."""
    def take(split, train, n):
        it = iter(jax_imagenet.ImageNetDataset(
            data_dir, FIXTURE_BATCH, image_size=FIXTURE_SIZE, split=split,
            train=train, seed=0, wire_dtype="uint8"))
        got = [next(it) for _ in range(n)]
        return np.stack([g[0] for g in got]), np.stack([g[1] for g in got])

    ti, tl = take("train", True, 2)
    ei, el = take("validation", False, 1)
    return {"train_images": ti, "train_labels": tl,
            "eval_images": ei[0], "eval_labels": el[0]}


def write_fixture(out_dir: Path) -> None:
    """Two train shards and one validation shard of 16 noise JPEGs at 96
    px, and the JAX pipeline's crops of them."""
    imagenet.make_synthetic_shards(out_dir, num_shards=2,
                                   examples_per_shard=16, image_size=96,
                                   seed=0)
    imagenet.make_synthetic_shards(out_dir, num_shards=1,
                                   examples_per_shard=16, image_size=96,
                                   seed=1, split="validation")
    np.savez_compressed(out_dir / "expected_crops.npz",
                        **jax_expected_crops(out_dir))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three train shards of 8 JPEGs at 40 px and a validation shard."""
    d = tmp_path_factory.mktemp("shards")
    imagenet.make_synthetic_shards(d, num_shards=3, examples_per_shard=8,
                                   image_size=40, seed=2)
    imagenet.make_synthetic_shards(d, num_shards=1, examples_per_shard=8,
                                   image_size=40, seed=3, split="validation")
    return d


# --- codec and scanner ------------------------------------------------------

PAYLOADS = [b"", b"x", b"hello", bytes(range(256)) * 5,
            np.random.default_rng(0).bytes(10_000)]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_crc32c_matches_jax_and_the_native_scanner(i):
    data = PAYLOADS[i]
    scanner = native.tfrecord_scanner()
    assert tfrecord.crc32c(data) == jax_tfrecord.crc32c(data) == \
        scanner.crc32c(data)
    assert tfrecord.masked_crc32c(data) == \
        jax_tfrecord.masked_crc32c(data) == scanner.masked_crc32c(data)


EXAMPLES = [
    {"image/encoded": [b"\xff\xd8jpeg"], "image/class/label": [7]},
    {"a": [b"x", b"", "text"], "b": [1.5, -2.25, 0.0],
     "c": [0, -1, 2 ** 40, -(2 ** 63)]},
    {"image/height": [224], "image/width": [300], "f": [3.0]},
]


@pytest.mark.parametrize("i", range(len(EXAMPLES)))
def test_examples_are_jax_s_bytes_and_parse_alike(i):
    feats = EXAMPLES[i]
    rec = tfrecord.build_example(feats)
    assert rec == jax_tfrecord.build_example(feats)
    assert tfrecord.parse_example(rec) == jax_tfrecord.parse_example(rec)


def _records(n=20, seed=0):
    rng = np.random.default_rng(seed)
    return [b""] + [rng.bytes(int(rng.integers(1, 3000)))
                    for _ in range(n - 1)]


def test_record_files_are_jax_s_bytes_and_the_scanner_reads_them(tmp_path):
    recs = _records()
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    assert tfrecord.write_records(mine, recs) == len(recs)
    jax_tfrecord.write_records(ref, recs)
    assert mine.read_bytes() == ref.read_bytes()
    scanner = native.tfrecord_scanner()
    assert list(tfrecord.read_records(mine, verify_crc=True)) == recs
    assert scanner.read_records(mine) == recs
    assert tfrecord.count_records(mine) == \
        jax_tfrecord.count_records(mine) == len(recs)
    offsets, lengths = scanner.index(mine)
    assert [int(n) for n in lengths] == [len(r) for r in recs]
    assert int(offsets[0]) == 12                 # past the first header


def _corrupt(path: Path, how: str) -> None:
    data = bytearray(path.read_bytes())
    if how == "payload":
        data[12 + 0 + 4 + 12 + 5] ^= 0xFF        # 2nd record, 6th byte
    elif how == "length_crc":
        data[8] ^= 0x01
    else:                                        # truncated
        data = data[:-3]
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("how", ["payload", "length_crc", "truncated"])
def test_corruption_is_detected(tmp_path, how):
    path = tmp_path / "shard"
    tfrecord.write_records(path, _records(5, seed=1))
    _corrupt(path, how)
    scanner = native.tfrecord_scanner()
    with pytest.raises(IOError):
        scanner.read_records(path, verify=True)
    with pytest.raises(IOError):
        list(tfrecord.read_records(path, verify_crc=True))
    if how == "payload":
        # the framing still holds: only the CRC check sees it
        assert len(scanner.read_records(path, verify=False)) == 5


def test_native_build_is_stamped_and_reused(tmp_path):
    lib = native.build("tfrecord", tmp_path)
    first = lib.stat().st_mtime_ns
    assert native.build("tfrecord", tmp_path) == lib
    assert lib.stat().st_mtime_ns == first           # no second compile
    assert lib.with_suffix(".so.sha256").exists()


def test_no_decoder_raises_naming_both(monkeypatch):
    def fail(name, build_dir=native.BUILD_DIR):
        raise RuntimeError(f"g++ could not build {name}")

    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no native JPEG decoder") as e:
        native._decoder.__wrapped__()
    assert "libjpeg" in str(e.value) and "nvjpeg" in str(e.value)


# --- the dataset ------------------------------------------------------------


def _batches(ds, n):
    it = iter(ds)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _assert_equal_batches(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("workers", [1, 4])
def test_dataset_is_jax_s_bitwise(shards, train, workers):
    kw = dict(image_size=32, train=train, seed=5, wire_dtype="uint8",
              decode_workers=workers,
              split="train" if train else "validation")
    mine = imagenet.ImageNetDataset(shards, 8, **kw)
    want = _batches(jax_imagenet.ImageNetDataset(shards, 8, **kw), 4)
    _assert_equal_batches(_batches(mine, 4), want)
    st = mine.stats()
    assert (st["reader"], st["decoder"], st["pil_fallbacks"]) == \
        ("native", "libjpeg", 0)
    assert st["decode_workers"] == workers and st["examples"] >= 32


def test_float32_wire_is_jax_s_bitwise(shards):
    kw = dict(image_size=24, train=True, seed=1, wire_dtype="float32")
    _assert_equal_batches(
        _batches(imagenet.ImageNetDataset(shards, 6, **kw), 3),
        _batches(jax_imagenet.ImageNetDataset(shards, 6, **kw), 3))


def test_two_ranks_sliced_rows_and_full_batch_identity(shards):
    """At world 2 each rank reads its own shards; its sliced rows equal
    JAX's sliced rows and its full batch's rows (the identity arm)."""
    b = 8
    for rank in range(2):
        rows = (rank * b // 2, (rank + 1) * b // 2)
        kw = dict(image_size=32, train=True, seed=7, wire_dtype="uint8",
                  worker=rank, num_workers=2)
        sliced = _batches(imagenet.ImageNetDataset(
            shards, b, decode_rows=rows, **kw), 3)
        full = _batches(imagenet.ImageNetDataset(shards, b, **kw), 3)
        ref = _batches(jax_imagenet.ImageNetDataset(
            shards, b, decode_rows=rows, **kw), 3)
        cut = [tuple(a[rows[0]:rows[1]] for a in x) for x in sliced]
        _assert_equal_batches(cut, [tuple(a[rows[0]:rows[1]] for a in x)
                                    for x in ref])
        _assert_equal_batches(cut, [tuple(a[rows[0]:rows[1]] for a in x)
                                    for x in full])


def test_shard_helpers_equal_jax_s(shards):
    for split in ("train", "validation"):
        assert imagenet.find_shards(shards, split) == \
            jax_imagenet.find_shards(shards, split)
        assert imagenet.count_examples(shards, split) == \
            jax_imagenet.count_examples(shards, split)
    found = imagenet.find_shards(shards)
    for w, n in ((0, 2), (1, 2), (3, 4), (0, 1)):
        assert imagenet.shards_for_worker(found, w, n) == \
            jax_imagenet.shards_for_worker(found, w, n)
    with pytest.raises(FileNotFoundError):
        imagenet.find_shards(shards, "test")
    assert imagenet.host_decode_budget() == jax_imagenet.host_decode_budget()


@pytest.mark.parametrize("train", [True, False])
def test_pil_route_and_sampler_equal_jax_s(train):
    from PIL import Image

    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (50, 70, 3), np.uint8)).save(
        buf, format="JPEG")
    data = buf.getvalue()
    for seed in range(4):
        for normalize in (False, True):
            got = imagenet._decode_and_crop_pil(
                data, 32, np.random.default_rng(seed), train, normalize)
            want = jax_imagenet._decode_and_crop_pil(
                data, 32, np.random.default_rng(seed), train, normalize)
            np.testing.assert_array_equal(got, want)
        assert imagenet._sample_train_crop(70, 50, np.random.default_rng(
            seed)) == jax_imagenet._sample_train_crop(
                70, 50, np.random.default_rng(seed))


def test_a_png_record_goes_to_pil_and_is_counted(tmp_path):
    from PIL import Image

    png = io.BytesIO()
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (40, 40, 3), np.uint8)).save(png, format="PNG")
    tfrecord.write_records(tmp_path / "train-00000-of-00001", [
        tfrecord.build_example({"image/encoded": [png.getvalue()],
                                "image/class/label": [3]})] * 2)
    kw = dict(image_size=16, train=True, seed=0, wire_dtype="uint8",
              decode_workers=1)
    ds = imagenet.ImageNetDataset(tmp_path, 2, **kw)
    _assert_equal_batches(_batches(ds, 1), _batches(
        jax_imagenet.ImageNetDataset(tmp_path, 2, **kw), 1))
    ds = imagenet.ImageNetDataset(tmp_path, 2, **kw)
    gen = ds._batches()              # no prefetch thread: one batch only
    next(gen)
    gen.close()
    assert ds.stats()["pil_fallbacks"] == ds.stats()["examples"] == 2


def test_committed_fixture_crops_are_the_jax_pipeline_s():
    """Provenance: the JAX pipeline on the committed shards gives the
    committed crops, and so does the port's (tolerance 0 here, where
    both decode with libjpeg)."""
    names = sorted(p.name for p in FIXTURE.iterdir())
    assert names == ["expected_crops.npz", "train-00000-of-00002",
                     "train-00001-of-00002", "validation-00000-of-00001"]
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) < 1 << 20
    with np.load(FIXTURE / "expected_crops.npz") as f:
        want = dict(f)
    got = jax_expected_crops(FIXTURE)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mine = _batches(imagenet.ImageNetDataset(
        FIXTURE, FIXTURE_BATCH, image_size=FIXTURE_SIZE, seed=0,
        wire_dtype="uint8"), 2)
    for k, (im, lb) in enumerate(mine):
        np.testing.assert_array_equal(im, want["train_images"][k])
        np.testing.assert_array_equal(lb, want["train_labels"][k])


def _fixture_crops(decoder: str) -> dict[str, np.ndarray]:
    """The port's pipeline on the fixture with ``decoder``, laid out as
    ``expected_crops.npz``."""
    def take(split, train, n):
        got = _batches(imagenet.ImageNetDataset(
            FIXTURE, FIXTURE_BATCH, image_size=FIXTURE_SIZE, split=split,
            train=train, seed=0, wire_dtype="uint8", decoder=decoder), n)
        return np.stack([g[0] for g in got]), np.stack([g[1] for g in got])

    ti, tl = take("train", True, 2)
    ei, el = take("validation", False, 1)
    return {"train_images": ti, "train_labels": tl,
            "eval_images": ei[0], "eval_labels": el[0]}


def test_pil_decoder_reproduces_the_fixture_crops():
    assert native.jpeg_decoder("pil").name == "pil"
    with np.load(FIXTURE / "expected_crops.npz") as f:
        want = dict(f)
    got = _fixture_crops("pil")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _photo(w: int, h: int, seed: int) -> bytes:
    """A smooth 4:2:0 JPEG with some texture (a photo's spectrum more
    than noise's)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / (17 + 5 * c) + y / 23 + c)
                    for c in range(3)], -1)
    img += rng.normal(0, 12, img.shape)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("denom", [1, 2, 4, 8])
def test_pil_decoder_equals_libjpeg_at_every_dct_scale(denom):
    """Crops that make ``decode_rgb``'s rule pick 1/``denom``: the pil
    decoder's pixels are libjpeg's, bit for bit, flipped or not."""
    out = 24
    cw = ch = out * denom + 5
    assert native._scale_denom(cw, ch, out) == denom
    pil, lj = native.jpeg_decoder("pil"), native.jpeg_decoder("libjpeg")
    for seed, (w, h) in enumerate(((333, 250), (250, 333), (401, 401))):
        data = _photo(w, h, seed)
        assert pil.dims(data) == lj.dims(data) == (w, h)
        for crop in ((0, 0, cw, ch), (w - cw, h - ch, cw, ch),
                     (7, 3, cw, ch)):
            for flip in (False, True):
                np.testing.assert_array_equal(
                    pil.decode_crop_resize(data, crop, out, flip),
                    lj.decode_crop_resize(data, crop, out, flip))


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_pil_decoder_opens_each_stream_once(monkeypatch, mode):
    """``decode_sampled``, the dataset's call: one ``Image.open`` a
    stream, ``sample`` called once with the header's size, and the
    pixels libjpeg's (a gray JPEG expanded to RGB alike)."""
    from PIL import Image

    pil, lj = native.jpeg_decoder("pil"), native.jpeg_decoder("libjpeg")
    data = _photo(333, 250, 3)
    if mode == "L":
        buf = io.BytesIO()
        Image.open(io.BytesIO(data)).convert("L").save(buf, format="JPEG")
        data = buf.getvalue()
    opens, sizes = [], []
    real_open = pil._image.open
    monkeypatch.setattr(pil._image, "open",
                        lambda *a: opens.append(1) or real_open(*a))

    def sample(w, h):
        sizes.append((w, h))
        return (9, 4, 110, 120), True

    got = pil.decode_sampled(data, sample, 24)
    assert opens == [1] and sizes == [(333, 250)]
    np.testing.assert_array_equal(
        got, lj.decode_crop_resize(data, (9, 4, 110, 120), 24, True))


def test_pil_decoder_sends_png_and_cmyk_to_the_pil_route(tmp_path):
    from PIL import Image

    pil = native.jpeg_decoder("pil")
    arr = np.random.default_rng(1).integers(0, 256, (40, 40, 3), np.uint8)
    for fmt, mode in (("PNG", "RGB"), ("JPEG", "CMYK")):
        buf = io.BytesIO()
        Image.fromarray(arr).convert(mode).save(buf, format=fmt)
        with pytest.raises(ValueError):
            pil.dims(buf.getvalue())
        with pytest.raises(ValueError):
            pil.decode_crop_resize(buf.getvalue(), (0, 0, 40, 40), 16)
    png = io.BytesIO()
    Image.fromarray(arr).save(png, format="PNG")
    tfrecord.write_records(tmp_path / "train-00000-of-00001", [
        tfrecord.build_example({"image/encoded": [png.getvalue()],
                                "image/class/label": [3]})] * 2)
    kw = dict(image_size=16, train=True, seed=0, wire_dtype="uint8",
              decode_workers=1)
    ds = imagenet.ImageNetDataset(tmp_path, 2, decoder="pil", **kw)
    gen = ds._batches()
    got = next(gen)
    gen.close()
    assert ds.stats()["pil_fallbacks"] == 2 and ds.decoder == "pil"
    _assert_equal_batches([got], _batches(
        jax_imagenet.ImageNetDataset(tmp_path, 2, **kw), 1))


def test_jpeg_decoder_order_is_libjpeg_pil_nvjpeg(monkeypatch):
    assert native.DECODERS == ("libjpeg", "pil", "nvjpeg")
    built = []
    real = native.build

    def no_libjpeg(name, build_dir=native.BUILD_DIR):
        built.append(name)
        if name == "libjpeg":
            raise RuntimeError("no jpeglib.h")
        return real(name, build_dir)

    monkeypatch.setattr(native, "build", no_libjpeg)
    assert native._decoder.__wrapped__().name == "pil"
    assert built == ["libjpeg", "crop_resize"]
    with pytest.raises(ValueError, match="one of"):
        native.jpeg_decoder("turbo")


# --- tokens -----------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("worker,workers", [(0, 1), (1, 2)])
def test_token_dataset_windows_equal_jax_s(tmp_path, causal, worker,
                                           workers):
    stream = np.random.default_rng(4).integers(0, 1000, 5000)
    path = tokens.write_token_file(tmp_path / "mine" / "train.bin", stream,
                                   1000)
    ref = jax_tokens.write_token_file(tmp_path / "ref" / "train.bin",
                                      stream, 1000)
    assert path.read_bytes() == ref.read_bytes()
    assert Path(str(path) + ".meta.json").read_text() == \
        Path(str(ref) + ".meta.json").read_text()
    kw = dict(global_batch=4, seq_len=32, causal_lm=causal, worker=worker,
              num_workers=workers, seed=3, vocab_size=1000)
    mine = iter(tokens.TokenDataset(tmp_path / "mine", **kw))
    want = iter(jax_tokens.TokenDataset(tmp_path / "mine", **kw))
    for _ in range(3):
        for a, b in zip(next(mine), next(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tokens._resolve(tmp_path / "mine", "validation")
    with pytest.raises(ValueError, match="vocab"):
        tokens.TokenDataset(tmp_path / "mine", 2, 8, vocab_size=10)


# --- the feeder on the CPU ---------------------------------------------------


def test_feeder_hands_out_the_model_layouts_in_order():
    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 256, (2, 6, 6, 3), np.uint8),
             rng.integers(0, 10, (2,), np.int32)) for _ in range(5)]
    got = list(DeviceFeeder(iter(host), torch.device("cpu"), depth=2))
    assert len(got) == 5
    for (x, y), (hx, hy) in zip(got, host):
        assert x.shape == (2, 3, 6, 6) and x.dtype == torch.uint8
        assert x.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(x.permute(0, 2, 3, 1).numpy(), hx)
        assert y.dtype == torch.int64
        np.testing.assert_array_equal(y.numpy(), hy)
    with pytest.raises(ValueError):
        DeviceFeeder(iter(host), torch.device("cpu"), depth=0)


def test_feeder_reraises_host_errors_and_closes_the_host():
    closed = []

    def host(n_good):
        try:
            for _ in range(n_good):
                yield (np.zeros((1, 2, 2, 3), np.uint8),)
            raise ValueError("not a JPEG")
        finally:
            closed.append(n_good)

    it = iter(DeviceFeeder(host(1), torch.device("cpu"), depth=1))
    assert next(it)[0].shape == (1, 3, 2, 2)
    with pytest.raises(ValueError, match="not a JPEG"):
        next(it)
    feeder = DeviceFeeder(host(10 ** 9), torch.device("cpu"), depth=2)
    it = iter(feeder)
    next(it)
    it.close()                          # the step loop stops early
    assert not feeder.thread.is_alive() and closed == [1, 10 ** 9]
    unused = DeviceFeeder(host(3), torch.device("cpu"))
    next(unused.host)                   # a started, never-fed host
    unused.close()
    assert closed[-1] == 3


def test_input_modules_import_no_jax_and_load_no_jax_library():
    """The port's input code imports nothing of JAX or of the JAX
    package, and never maps a library from ``tpu_hc_bench/native``."""
    code = (
        "import sys, numpy as np\n"
        "from tpu_hc_bench_torch import native\n"
        "from tpu_hc_bench_torch.data import imagenet, feed, tokens, "
        "tfrecord\n"
        "ds = imagenet.ImageNetDataset(sys.argv[1], 2, image_size=16, "
        "decode_workers=1)\n"
        "it = iter(ds); next(it); it.close()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'tpu_hc_bench/native' not in maps, 'JAX native lib loaded'\n"
        "assert 'libthb_libjpeg.so' in maps and 'libthb_tfrecord.so' in "
        "maps\n"
        "assert 'jax' not in sys.modules\n"
        "assert 'tpu_hc_bench' not in sys.modules\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(FIXTURE)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr


if __name__ == "__main__":
    write_fixture(Path(sys.argv[1]))
