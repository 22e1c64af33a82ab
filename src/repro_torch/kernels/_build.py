"""Build and load the port's hand-written CUDA kernels.

All ``kernels/*/csrc/*.cu`` sources compile into one shared library with
a plain C interface (no PyTorch headers), under ``build/kernels/`` at the
repository root: one ``nvcc`` process per source, all started together,
then one link, so the build takes as long as its slowest source. The
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
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC"]
NVCC_FLAGS = [*COMPILE_FLAGS, "-shared"]   # one source straight to a library

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
    # q, k, v, out, lse, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap,
    # scale, dtype, stream
    "flash_attention_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, ctypes.c_float, ctypes.c_float, _I,
                               _P],
    # q, k, v, out, lse, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap,
    # scale, dtype, stream
    "flash_attention_sm90_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, ctypes.c_float,
                                    ctypes.c_float, _I, _P],
    # out, dout, delta, B, Sq, H, D, dtype, stream
    "flash_bwd_dot_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, delta, part, B, Sq, Skv, q_offset, H, Hkv, D,
    # window, softcap, scale, dtype, stream
    "flash_bwd_dkdv_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, ctypes.c_float,
                              ctypes.c_float, _I, _P],
    # the tensor-core instance of the dK/dV and dQ launches: the same
    # arguments as flash_bwd_dkdv_launch and flash_bwd_dq_launch
    "flash_bwd_dkdv_wgmma_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _I, ctypes.c_float,
                                    ctypes.c_float, _I, _P],
    "flash_bwd_dq_wgmma_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, ctypes.c_float,
                                  ctypes.c_float, _I, _P],
    # the float32 tensor-core instance (3xTF32): B, Sq, Skv, H, Hkv, D ->
    # the floats of its split planes' workspace (0: shapes refused)
    "flash_bwd_tf32_workspace_floats": [_I, _I, _I, _I, _I, _I],
    # q, k, v, out, dout, delta, workspace, B, Sq, Skv, H, Hkv, D, dtype,
    # stream
    "flash_bwd_split_tf32_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _P],
    # workspace, lse, delta, part, B, Sq, Skv, q_offset, H, Hkv, D, window,
    # softcap, scale, stream
    "flash_bwd_dkdv_tf32_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, ctypes.c_float, ctypes.c_float,
                                   _P],
    # workspace, lse, delta, dq, B, Sq, Skv, q_offset, H, Hkv, D, window,
    # softcap, scale, dtype, stream
    "flash_bwd_dq_tf32_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, ctypes.c_float, ctypes.c_float, _I, _P],
    # part, dk, dv, n, G, D, dtype, stream
    "flash_bwd_dkdv_sum_launch": [_P, _P, _P, ctypes.c_longlong, _I, _I, _I,
                                  _P],
    # q, k, v, dout, lse, delta, dq, B, Sq, Skv, q_offset, H, Hkv, D,
    # window, softcap, scale, dtype, stream
    "flash_bwd_dq_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, ctypes.c_float, ctypes.c_float, _I,
                            _P],
    # values, timestamps, valid, window_start, out, observed, E, S, M, T,
    # tick_s, impl, vec, stream
    "harmonize_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         ctypes.c_float, _I, _I, _P],
}
# the entry points that return something other than a cudaError_t code
RESTYPES = {"flash_bwd_tf32_workspace_floats": ctypes.c_longlong}

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
    nvcc, pid = _nvcc(), os.getpid()
    tmp = LIB_PATH.with_suffix(f".{pid}.tmp")
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.parents[1].name}.{src.stem}.{pid}.o"
        cmd = [nvcc, *COMPILE_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        failed = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{err}")
            elif verbose:
                print(err, end="")
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
    finally:
        for _, obj, proc in jobs:
            proc.wait()
            obj.unlink(missing_ok=True)
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
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def as_float32(x):
    """An op entry's value input as the kernels read it: float32 (any
    floating, integer or bool dtype cast, as the reference's op entries
    cast with ``astype(float32)``), densely packed. A float32 contiguous
    tensor passes through as it is."""
    return x.to(torch.float32).contiguous()


def as_mask(x):
    """An op entry's mask input as the reference's op entries read one:
    ``astype(float32) > 0``, so a mask of -1 (or NaN) is False. A bool
    tensor passes through as it is."""
    if x.dtype == torch.bool:
        return x.contiguous()
    return (x.to(torch.float32) > 0).contiguous()


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
