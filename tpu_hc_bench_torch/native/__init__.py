"""ctypes bindings of the port's native input code: the TFRecord scanner
(``tfrecord_reader.cpp``) and the JPEG decoders (``jpeg_decoder.cpp`` on
libjpeg, ``nvjpeg_decoder.cpp`` on nvJPEG), copies of the JAX package's
``native/`` sources plus the nvJPEG decoder.

Each library is built by ``g++`` at first use into ``build/torch_native/``
at the root of the checkout (never at import, and never by ``nvcc``), under
a lock file as the CUDA kernels are (``ops._build.build_stamped``), and
rebuilt when the hash of its source and flags differs from the one
stamped beside it.

- ``tfrecord_scanner()``: the scanner, required; a failed build raises.
- ``jpeg_decoder()``: the decoder that builds here, libjpeg first (the JAX
  package's decoder: the same pixels), then nvJPEG from the CUDA toolkit
  (``$CUDA_HOME``, else ``/usr/local/cuda``) where there is a GPU.  Its
  ``name`` says which; neither building raises, naming both failures.
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

__all__ = ["BUILD_DIR", "JpegDecoder", "TfrecordScanner", "jpeg_decoder",
           "tfrecord_scanner"]

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
            "nvjpeg": "nvjpeg_decoder.cpp"}


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


_lock = threading.Lock()


@functools.lru_cache(maxsize=1)
def _scanner() -> TfrecordScanner:
    return TfrecordScanner(build("tfrecord"))


@functools.lru_cache(maxsize=1)
def _decoder() -> JpegDecoder:
    errors = []
    for name in ("libjpeg", "nvjpeg"):
        if name == "nvjpeg":
            import torch

            if not torch.cuda.is_available():
                errors.append("nvjpeg: no CUDA device")
                continue
        try:
            return JpegDecoder(name, build(name))
        except (RuntimeError, OSError) as e:
            errors.append(f"{name}: {e}")
    raise RuntimeError("no native JPEG decoder builds on this machine:\n"
                       + "\n".join(errors))


def tfrecord_scanner() -> TfrecordScanner:
    """The native scanner (built at first use; raises when g++ cannot
    build it)."""
    with _lock:
        return _scanner()


def jpeg_decoder() -> JpegDecoder:
    """The native JPEG decoder of this machine: libjpeg where its headers
    are, else nvJPEG on the GPU; raises when neither builds."""
    with _lock:
        return _decoder()
