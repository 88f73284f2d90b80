"""Build and load the hand-written CUDA kernels of ``tpu_hc_bench_torch``.

The counterpart of ``tpu_hc_bench/ops/_pallas.py``: the shared plumbing
of the kernel modules.  Every ``csrc/*.cu`` source is compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, ``build/torch_kernels/libthb_kernels.so`` at the root of the
checkout, and loaded with ``ctypes``.  Each source compiles in its own
``nvcc`` process, all started together, then one link step joins them.

The build runs at first use, never at import: the CPU tests import every
module on machines with no ``nvcc``.  It is redone only when the hash of
the sources and flags differs from the one stamped beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["pad_up", "load_library", "check", "stream_ptr", "BUILD_DIR"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_LIB_NAME = "libthb_kernels.so"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry -> argtypes; every pointer and the stream are c_void_p, so a
# 64-bit address is never cut to a 32-bit int
_SIGNATURES = {
    "thb_paged_decode_attention": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,         # q k v ks vs tbl len o lse
        _I, _I, _I, _I, _I, _I, _I, _I, _I,         # b h kvh d pages ps w ppb l
        _F, _I, _P],                                # scale quantized stream
    "thb_fused_residual_norm": [
        _P, _P, _P, _P, _P, _P,                     # res x gamma beta y out
        _I, _I, _F, _I, _P],                        # rows hidden eps ln stream
}


def pad_up(x: int, m: int) -> int:
    """``x`` rounded up to the next multiple of ``m``."""
    return (x + m - 1) // m * m


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "tpu_hc_bench_torch are compiled at first use on the GPU machine")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source and the compile flags."""
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(_CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()


def build(build_dir: Path = BUILD_DIR) -> tuple[Path, float, str]:
    """Compile the sources into the shared library when the stamped hash
    differs; returns ``(library path, seconds spent, compiler log)``."""
    lib = build_dir / _LIB_NAME
    stamp = build_dir / (_LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, 0.0, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = build_dir / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *_ARCH, *_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(log))
    tmp = build_dir / (_LIB_NAME + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *_ARCH, "-shared", "-o", str(tmp),
         *[str(build_dir / (s.stem + ".o")) for s in _sources()]],
        capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib, time.perf_counter() - t0, "\n".join(log)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built library with every entry's ``argtypes``/``restype`` set
    (built first if needed; once per process)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error from its launch."""
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
