"""Build and load the port's hand-written CUDA kernels.

All ``kernels/*/csrc/*.cu`` sources compile in ONE ``nvcc`` call into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), under ``build/kernels/`` at the repository root. The
library is built at first use and rebuilt when a source or a
``kernels/*.cuh`` header they include is newer than it; it is loaded with
``ctypes``. A failed build raises with ``nvcc``'s
stderr. Nothing here runs at import time.

Every C entry point launches on the current device, so the wrappers
launch under :func:`on_device`. Every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` turns a
non-zero code into an exception, so a launch the card refuses (too many
threads, a bad configuration) never passes silently.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
LIB_PATH = BUILD_DIR / "librepro_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: argtypes, declared once so ctypes never
# passes a pointer or the stream as a 32-bit int
SIGNATURES = {
    # values, observed, init_value, init_has, out, has, R, T, impl, vec,
    # stream
    "locf_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # values, mask, mean, var, stats, spikes, R, T, k_sigma, impl, vec,
    # stream
    "window_agg_launch": [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float,
                          _I, _I, _P],
    # a, b, h0, hs, h_last, B, T, W, stream
    "rglru_scan_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, out, B, S, H, Hkv, D, window, softcap, scale, dtype, stream
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, ctypes.c_float, _I, _P],
    # q, k, v, out, B, S, H, Hkv, D, window, softcap, scale, stream (bf16)
    "flash_attention_sm90_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    ctypes.c_float, ctypes.c_float, _P],
    # values, timestamps, valid, window_start, out, observed, E, S, M, T,
    # tick_s, vec, stream
    "harmonize_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         ctypes.c_float, _I, _P],
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(_PKG.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "can only be built on a machine with the toolkit")
    return found


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built
               for s in (*sources(), *_PKG.glob("*.cuh")))


def build(verbose: bool = False) -> float:
    """Compile every kernel source into the shared library if it is missing
    or older than a source. Returns the seconds spent compiling (0.0 when
    the library was current). ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's report (registers, shared memory, spills per kernel)."""
    if not _stale():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def library():
    """The loaded kernel library (built first if needed), argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def require(name: str, t, dtype, shape, device) -> None:
    """Validate one wrapper argument before any pointer is taken: the
    kernels take exactly this dtype, shape and device, densely packed."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device):
    """Make ``device`` the current CUDA device for a launch (a no-op for
    the CPU). The C entries launch ``<<<..., stream>>>`` on the current
    device, so a tensor on another card than the current one would
    otherwise meet a stream of the wrong device. Every wrapper launches
    under it, and the sharded engines run each shard under it; on one
    card it changes nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)
