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
Processes that build at once (the workers of one host) take turns on a
lock file in the build directory: the first compiles, the others find
its stamp.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
_L = ctypes.c_longlong
_QKV_STRIDES = [_L] * 9                             # b, s, h of q k v

# C entry -> argtypes; every pointer and the stream are c_void_p, so a
# 64-bit address is never cut to a 32-bit int
_SIGNATURES = {
    "thb_paged_decode_attention": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,         # q k v ks vs tbl len o lse
        _P, _P,                                     # ws_acc ws_ml
        _I, _I, _I, _I, _I, _I, _I, _I, _I,         # b h kvh d pages ps w ppb l
        _I, _I, _I,                                 # splits slots g_tile
        _F, _I, _I, _I, _P],                        # scale pool q_bf16 vec
                                                    # stream
    "thb_fused_residual_norm": [
        _P, _P, _P, _P, _P, _P,                     # res x gamma beta y out
        _I, _I, _F, _I,                             # rows hidden eps ln
        _I, _I, _I, _I, _I, _I, _I,                 # dtype gamma_f32 cluster
                                                    # threads team nv vec
        _P],                                        # stream
    "thb_empty_launch": [_I, _P],                   # cluster stream
    "thb_fused_bn_relu_conv": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,         # x w a b y p1 p2 s1 s2
        _I, _I, _I, _I, _I,                         # n h w cin cout
        _I, _I, _P],                                # design part_rows stream
    "thb_flash_attention_fwd": [
        _P, _P, _P, _P, _P,                         # q k v o lse
        _I, _I, _I, _I, _I, *_QKV_STRIDES,          # b h sq sk d strides
        _F, _I, _I,                                 # scale causal bf16
        ctypes.POINTER(_I), _P],                    # design (out) stream
    "thb_flash_attention_dq": [
        _P, _P, _P, _P, _P, _P, _P,                 # q k v do lse delta dq
        _I, _I, _I, _I, _I, *_QKV_STRIDES,
        _F, _I, _I, ctypes.POINTER(_I), _P],
    "thb_flash_attention_dkv": [
        _P, _P, _P, _P, _P, _P, _P, _P,             # q k v do lse delta dk dv
        _I, _I, _I, _I, _I, *_QKV_STRIDES,
        _F, _I, _I, ctypes.POINTER(_I), _P],
    "thb_softmax_xent_fwd": [
        _P, _P, _P, _P,                             # logits labels loss lse
        _I, _I, _I, _P],                            # n v dtype stream
    "thb_softmax_xent_bwd": [
        _P, _P, _P, _P, _P,                         # logits labels lse g dx
        _I, _I, _I, _P],                            # n v dtype stream
    "thb_max_pool_bwd": [
        _P, _P, _P, _P,                             # x y dy dx
        _I, _I, _I, _I, _I, _I,                     # b h w c ho wo
        _I, _I, _I, _I, _I, _I,                     # wh ww sh sw top left
        _I, _I, _P],                                # aligned dtype stream
    "thb_sm90_wgmma_tile": [
        _P, _P, _P, _I, _I, _I, _P],                # a b c n k mode stream
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


@contextlib.contextmanager
def _locked(build_dir: Path):
    """Hold an exclusive lock on ``build_dir``'s lock file."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(build_dir: Path = BUILD_DIR) -> tuple[Path, float, str]:
    """Compile the sources into the shared library when the stamped hash
    differs; returns ``(library path, seconds spent, compiler log)``."""
    lib = build_dir / _LIB_NAME
    stamp = build_dir / (_LIB_NAME + ".sha256")
    digest = source_hash()

    def current() -> bool:
        return lib.exists() and stamp.exists() and \
            stamp.read_text() == digest

    if current():
        return lib, 0.0, ""
    with _locked(build_dir):
        if current():                   # another process built it
            return lib, 0.0, ""
        return lib, *_compile(build_dir, lib, stamp, digest)


def _compile(build_dir: Path, lib: Path, stamp: Path,
             digest: str) -> tuple[float, str]:
    """One ``nvcc`` a source, all started together, then the link; the
    library and its stamp replace the old ones last."""
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
    return time.perf_counter() - t0, "\n".join(log)


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


# PyTorch's own raw-handle query, what its compiled kernels launch with:
# it builds no ``torch.cuda.Stream`` object, whose construction costs more
# host time than the launch itself, on every kernel call of a host-bound
# decode loop
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    if _RAW_STREAM is not None:
        index = device.index
        return _RAW_STREAM(torch.cuda.current_device() if index is None
                           else index)
    return torch.cuda.current_stream(device).cuda_stream
