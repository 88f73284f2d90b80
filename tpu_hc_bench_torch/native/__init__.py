"""ctypes bindings of the port's native input code: the TFRecord scanner
(``tfrecord_reader.cpp``) and the JPEG decoders (``jpeg_decoder.cpp`` on
libjpeg, ``crop_resize.cpp`` behind PIL's decode, ``nvjpeg_decoder.cpp``
on nvJPEG), copies of the JAX package's ``native/`` sources plus the
last two.

Each library is built by ``g++`` at first use into ``build/torch_native/``
at the root of the checkout (never at import, and never by ``nvcc``), under
a lock file as the CUDA kernels are (``ops._build.build_stamped``), and
rebuilt when the hash of its source and flags differs from the one
stamped beside it.

- ``tfrecord_scanner()``: the scanner, required; a failed build raises.
- ``jpeg_decoder()``: the first decoder that builds here, in this order:

  1. ``libjpeg``: the system libjpeg, the JAX package's decoder (the same
     pixels); it needs ``jpeglib.h``;
  2. ``pil``: PIL's own libjpeg-turbo, DCT-scaled as libjpeg is
     (``Image.draft("RGB", (W // d, H // d))`` with ``d`` picked by
     ``decode_rgb``'s rule), then ``crop_resize.cpp``: the same pixels as
     libjpeg where the two libraries decode alike, and no headers needed;
     PIL's decode leaves the GIL, so it runs in the decode pool's threads;
  3. ``nvjpeg``: nvJPEG from the CUDA toolkit (``$CUDA_HOME``, else
     ``/usr/local/cuda``) where there is a GPU; it decodes at full
     resolution, so its crops differ by decoder rounding and resize.

  Its ``name`` says which; none building raises, naming every failure.
  ``jpeg_decoder(name)`` takes one by name, and raises if it does not
  build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from tpu_hc_bench_torch.ops._build import build_stamped

__all__ = ["BUILD_DIR", "DECODERS", "JpegDecoder", "PilDecoder",
           "TfrecordScanner", "jpeg_decoder", "tfrecord_scanner"]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def _link_args(name: str) -> list[str]:
    if name == "libjpeg":
        return ["-ljpeg"]
    if name == "nvjpeg":
        cuda = _cuda_home()
        lib = cuda / "lib64"
        return [f"-I{cuda / 'include'}", f"-L{lib}", f"-Wl,-rpath,{lib}",
                "-lnvjpeg", "-lcudart"]
    return []


_SOURCES = {"tfrecord": "tfrecord_reader.cpp", "libjpeg": "jpeg_decoder.cpp",
            "nvjpeg": "nvjpeg_decoder.cpp", "crop_resize": "crop_resize.cpp"}
# jpeg_decoder()'s order
DECODERS = ("libjpeg", "pil", "nvjpeg")


def build(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """``build_dir/libthb_<name>.so``, compiled by ``g++`` when its stamp
    differs from the hash of the source, the shared header and the flags;
    raises ``RuntimeError`` with the compiler's output when g++ fails."""
    src = _DIR / _SOURCES[name]
    cmd_tail = [*_CXX_FLAGS, str(src), *_link_args(name)]
    h = hashlib.sha256(" ".join(cmd_tail).encode())
    for f in (src, _DIR / "crop_resize.h"):
        h.update(f.read_bytes())
    digest = h.hexdigest()

    def make(lib: Path, stamp: Path) -> tuple[float, str]:
        tmp = build_dir / f"{lib.name}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", "-o", str(tmp), *cmd_tail],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ could not build {lib.name} from "
                               f"{src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        stamp.write_text(digest)
        return 0.0, ""

    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / f"libthb_{name}.so"
    build_stamped(lib, digest, make)
    return lib


class TfrecordScanner:
    """The native TFRecord scanner: CRC32C and CRC-verified record
    indexing of a shard."""

    name = "native"

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        lib.thb_crc32c.restype = ctypes.c_uint32
        lib.thb_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.thb_masked_crc32c.restype = ctypes.c_uint32
        lib.thb_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.thb_index_file.restype = ctypes.c_int64
        lib.thb_index_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))]
        lib.thb_free.restype = None
        lib.thb_free.argtypes = [ctypes.c_void_p]
        self._lib = lib

    def crc32c(self, data: bytes) -> int:
        return self._lib.thb_crc32c(data, len(data))

    def masked_crc32c(self, data: bytes) -> int:
        return self._lib.thb_masked_crc32c(data, len(data))

    def index(self, path: str | Path, verify: bool = True
              ) -> tuple[np.ndarray, np.ndarray]:
        """``(payload_offsets, lengths)`` of every record; ``IOError`` on
        a truncated or (``verify``) corrupt file."""
        offs = ctypes.POINTER(ctypes.c_uint64)()
        lens = ctypes.POINTER(ctypes.c_uint64)()
        n = self._lib.thb_index_file(str(path).encode(), 1 if verify else 0,
                                     ctypes.byref(offs), ctypes.byref(lens))
        if n < 0:
            raise IOError(f"thb_index_file({path}) failed with code {n}")
        if n == 0:
            return np.empty((0,), np.uint64), np.empty((0,), np.uint64)
        try:
            return (np.ctypeslib.as_array(offs, shape=(n,)).copy(),
                    np.ctypeslib.as_array(lens, shape=(n,)).copy())
        finally:
            self._lib.thb_free(offs)
            self._lib.thb_free(lens)

    def read_records(self, path: str | Path,
                     verify: bool = True) -> list[bytes]:
        """Every record payload of a shard: the native index, then one
        buffered read."""
        offsets, lengths = self.index(path, verify=verify)
        data = Path(path).read_bytes()
        return [data[int(o):int(o) + int(n)]
                for o, n in zip(offsets, lengths)]


class JpegDecoder:
    """One of the native JPEG decoders (``name``: ``libjpeg`` or
    ``nvjpeg``); both take the same calls and crop and resize alike."""

    def __init__(self, name: str, path: Path):
        lib = ctypes.CDLL(str(path))
        lib.thb_jpeg_dims.restype = ctypes.c_int
        lib.thb_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.thb_decode_crop_resize.restype = ctypes.c_int
        lib.thb_decode_crop_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        if name == "nvjpeg":
            import torch

            lib.thb_jpeg_set_device.restype = ctypes.c_int
            lib.thb_jpeg_set_device.argtypes = [ctypes.c_int]
            lib.thb_jpeg_set_device(torch.cuda.current_device())
        self.name, self._lib = name, lib

    def _check(self, rc: int, what: str) -> None:
        if rc == 3:
            raise RuntimeError(f"{self.name} {what}: CUDA or nvJPEG setup "
                               "failed")
        if rc:
            raise ValueError(f"{self.name} {what} failed with code {rc}")

    def dims(self, data: bytes) -> tuple[int, int]:
        """``(width, height)`` without decoding; ``ValueError`` when the
        decoder cannot parse ``data``."""
        w, h = ctypes.c_int(), ctypes.c_int()
        self._check(self._lib.thb_jpeg_dims(data, len(data), ctypes.byref(w),
                                            ctypes.byref(h)), "dims")
        return w.value, h.value

    def decode_crop_resize(self, data: bytes,
                           crop: tuple[int, int, int, int], out_size: int,
                           flip: bool = False) -> np.ndarray:
        """Decode, crop ``(x, y, w, h)``, bilinear-resize to ``[out_size]^2``
        uint8 RGB (flipped left-right on ``flip``); ``ValueError`` on a
        stream the decoder cannot take."""
        out = np.empty((out_size, out_size, 3), np.uint8)
        self._check(self._lib.thb_decode_crop_resize(
            data, len(data), crop[0], crop[1], crop[2], crop[3], out_size,
            1 if flip else 0, out.ctypes.data_as(ctypes.c_void_p)), "decode")
        return out

    def decode_sampled(self, data: bytes, sample, out_size: int) -> np.ndarray:
        """``decode_crop_resize`` of the ``(crop, flip)`` that
        ``sample(width, height)`` draws from the header's size."""
        crop, flip = sample(*self.dims(data))
        return self.decode_crop_resize(data, crop, out_size, flip)


def _scale_denom(cw: int, ch: int, out_size: int) -> int:
    """``decode_rgb``'s DCT scale rule (``jpeg_decoder.cpp``): the largest
    of 1, 2, 4, 8 that keeps the crop at least ``out_size`` on both
    axes."""
    denom = 1
    for d in (2, 4, 8):
        if cw // d >= out_size and ch // d >= out_size:
            denom = d
    return denom


class PilDecoder:
    """The ``pil`` decoder: PIL decodes (its libjpeg-turbo, DCT-scaled
    through ``Image.draft`` as ``jpeg_decoder.cpp`` scales libjpeg), and
    ``crop_resize.cpp`` crops and resizes; the calls of ``JpegDecoder``.
    A stream that is not a JPEG, or a CMYK one (which libjpeg's RGB
    output refuses too), raises ``ValueError``."""

    name = "pil"

    def __init__(self, path: Path):
        from PIL import Image

        lib = ctypes.CDLL(str(path))
        lib.thb_crop_resize.restype = ctypes.c_int
        lib.thb_crop_resize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        self._lib, self._image = lib, Image

    def _open(self, data: bytes):
        import io

        try:
            img = self._image.open(io.BytesIO(data))
        except OSError as e:
            raise ValueError(f"pil cannot parse the stream: {e}") from None
        if img.format != "JPEG" or img.mode not in ("RGB", "L"):
            raise ValueError(f"pil decoder: a {img.format} {img.mode} "
                             "stream, not a baseline RGB or gray JPEG")
        return img

    def dims(self, data: bytes) -> tuple[int, int]:
        """``(width, height)`` from the header, without decoding."""
        return self._open(data).size

    def decode_crop_resize(self, data: bytes,
                           crop: tuple[int, int, int, int], out_size: int,
                           flip: bool = False) -> np.ndarray:
        """As ``JpegDecoder.decode_crop_resize``."""
        return self._crop_resize(self._open(data), crop, out_size, flip)

    def decode_sampled(self, data: bytes, sample, out_size: int) -> np.ndarray:
        """As ``JpegDecoder.decode_sampled``, the stream opened once."""
        img = self._open(data)
        crop, flip = sample(*img.size)
        return self._crop_resize(img, crop, out_size, flip)

    def _crop_resize(self, img, crop: tuple[int, int, int, int],
                     out_size: int, flip: bool) -> np.ndarray:
        w, h = img.size
        d = _scale_denom(crop[2], crop[3], out_size)
        img.draft("RGB", (w // d, h // d))
        want = (-(-w // d), -(-h // d))
        if img.size != want:
            raise RuntimeError(f"pil decoder: draft scaled {w}x{h} to "
                               f"{img.size}, not 1/{d} ({want})")
        try:
            # a gray JPEG stays "L" under draft; an RGB one is read as is
            pixels = np.asarray(img if img.mode == "RGB"
                                else img.convert("RGB"))
        except OSError as e:
            raise ValueError(f"pil cannot decode the stream: {e}") from None
        out = np.empty((out_size, out_size, 3), np.uint8)
        rc = self._lib.thb_crop_resize(
            pixels.ctypes.data_as(ctypes.c_void_p), pixels.shape[1],
            pixels.shape[0], d, crop[0], crop[1], crop[2], crop[3], out_size,
            1 if flip else 0, out.ctypes.data_as(ctypes.c_void_p))
        if rc:
            raise ValueError(f"pil decode failed with code {rc}")
        return out


_lock = threading.Lock()


@functools.lru_cache(maxsize=1)
def _scanner() -> TfrecordScanner:
    return TfrecordScanner(build("tfrecord"))


def _make_decoder(name: str) -> JpegDecoder | PilDecoder:
    if name == "pil":
        return PilDecoder(build("crop_resize"))
    if name == "nvjpeg":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
    return JpegDecoder(name, build(name))


_named_decoder = functools.lru_cache(maxsize=None)(_make_decoder)


@functools.lru_cache(maxsize=1)
def _decoder() -> JpegDecoder | PilDecoder:
    errors = []
    for name in DECODERS:
        try:
            return _make_decoder(name)
        except (RuntimeError, OSError, ImportError) as e:
            errors.append(f"{name}: {e}")
    raise RuntimeError("no native JPEG decoder builds on this machine:\n"
                       + "\n".join(errors))


def tfrecord_scanner() -> TfrecordScanner:
    """The native scanner (built at first use; raises when g++ cannot
    build it)."""
    with _lock:
        return _scanner()


def jpeg_decoder(name: str | None = None) -> JpegDecoder | PilDecoder:
    """The JPEG decoder of this machine, the first of ``DECODERS`` that
    builds (raises when none does); or the one ``name``d, which raises
    when it does not build."""
    with _lock:
        if name is None:
            return _decoder()
        if name not in DECODERS:
            raise ValueError(f"JPEG decoder must be one of {DECODERS}: "
                             f"{name!r}")
        return _named_decoder(name)
