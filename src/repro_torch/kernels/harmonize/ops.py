"""Wrapper of the harmonize kernel (``csrc/harmonize.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises. The kernel has two instances, named by
:func:`impl_for` from the tick count, statically: ``"warp"`` (one warp per
row, each sample bucketed once, each tick's hits added in M order; T <=
``MAX_T``), which serves the decision loop's windows (M = 32, T = 8) and
the fleet's (M = 128, T = 64) alike, and ``"tiled"`` (T > ``MAX_T``; a
week of 30 s ticks, T = 20,160: a block per row buckets each sample once,
sorts each chunk of ``SORT_CHUNK`` samples by tick with a stable radix
sort, adds each tick's run of hits in M order into a staging tile of
``TILE`` ticks, or of a whole week's where M exceeds one chunk, and
writes the tile's means). Both equal a sequential float32 loop bit for
bit.
``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_IMPL`` the same per
instance. Like the reference's op entry point, this is not wired into the
pipeline tick, which harmonizes through ``core.harmonize.harmonize_segment``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.harmonize.ref import harmonize_ref
from repro_torch.kernels.rows import aligned

LAUNCHES = 0
LAUNCHES_BY_IMPL = {"warp": 0, "tiled": 0}
_IMPLS = {"warp": 0, "tiled": 1}   # the C entry point's `impl` argument
# the warp instance keeps a row's T totals, counts and group masks in
# shared memory (12 bytes a tick); a block has 227 KB of it
MAX_T = 19_000
# the tiled instance: samples a sort covers (csrc: kSortChunk), and ticks a
# staging tile holds when the row is one chunk (csrc: kTile)
SORT_CHUNK = 2048
TILE = 2048


def impl_for(M: int, aligned: bool, n_ticks: int) -> tuple[str, bool]:
    """(instance, vec) for rows of M samples into ``n_ticks`` ticks:
    ``"warp"`` up to ``MAX_T`` ticks, ``"tiled"`` above; and whether it
    loads 128 samples a warp as float4 values and timestamps and 4-byte
    words of flags (``aligned``: every input pointer 16-byte aligned; and
    M % 4 == 0, so that every row starts aligned)."""
    return ("warp" if n_ticks <= MAX_T else "tiled"), aligned and M % 4 == 0


def harmonize(values, timestamps, valid, window_start, *, tick_s: float,
              n_ticks: int):
    """Batched entry: (E, S, M) raw samples -> (E, S, T) tick means.

    Values, timestamps and window_start (E,) of any dtype are read as
    float32, and valid as ``> 0`` after a float32 cast, as the reference's
    entry reads them. Returns (values (E, S, T) float32, observed
    (E, S, T) bool).
    """
    global LAUNCHES
    values, timestamps, window_start = map(
        _build.as_float32, (values, timestamps, window_start))
    valid = _build.as_mask(valid)
    E, S, M = values.shape
    dev = values.device
    _build.require("values", values, torch.float32, (E, S, M), dev)
    _build.require("timestamps", timestamps, torch.float32, (E, S, M), dev)
    _build.require("valid", valid, torch.bool, (E, S, M), dev)
    _build.require("window_start", window_start, torch.float32, (E,), dev)
    if n_ticks < 1 or not tick_s > 0:
        raise ValueError("harmonize: need n_ticks >= 1 and tick_s > 0")
    R = E * S
    if dev.type == "cpu":
        t0 = window_start[:, None].expand(E, S).reshape(R)
        out, obs = harmonize_ref(values.reshape(R, M),
                                 timestamps.reshape(R, M),
                                 valid.reshape(R, M), t0, tick_s, n_ticks)
        return out.reshape(E, S, n_ticks), obs.reshape(E, S, n_ticks)
    if dev.type != "cuda":
        raise ValueError(f"harmonize: no kernel for device {dev}")
    impl, vec = impl_for(M, aligned(values, timestamps, valid), n_ticks)
    lib = _build.library()
    out = torch.empty((E, S, n_ticks), dtype=torch.float32, device=dev)
    obs = torch.empty((E, S, n_ticks), dtype=torch.bool, device=dev)
    with _build.on_device(dev):
        _build.check(lib.harmonize_launch(
            values.data_ptr(), timestamps.data_ptr(), valid.data_ptr(),
            window_start.data_ptr(), out.data_ptr(), obs.data_ptr(), E, S, M,
            n_ticks, float(tick_s), _IMPLS[impl], int(vec),
            _build.stream_ptr(dev)), f"harmonize ({impl})")
    LAUNCHES += 1
    LAUNCHES_BY_IMPL[impl] += 1
    return out, obs
