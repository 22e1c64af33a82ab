"""The instance choice shared by the two row kernels, locf and window_agg.

Each has two CUDA instances over (R, T) rows (``<name>/csrc/*.cu``, with
the loads and stores of ``row_io.cuh``), picked here from T and the
pointers' alignment, statically and never by a failure:

- ``"row"`` (T <= ``ROW_MAX_T``): one thread per row, T a template
  parameter, the row in registers with all its loads issued at once;
  float4 values and packed flag words when T % 4 == 0 and the pointers are
  16-byte aligned (``vec``), else scalars.
- ``"warp"`` (longer rows): one warp per row over chunks of 64 ticks, two
  a lane, so each warp access is coalesced; a float2 and two flag bytes a
  lane when T is even and the pointers are aligned, else scalars.
"""
from __future__ import annotations

ROW_MAX_T = 16    # the row instances are T = 1 ... 16
IMPLS = {"row": 0, "warp": 1}   # the C entry points' `impl` argument


def impl_for(T: int, aligned: bool) -> tuple[str, bool]:
    """(instance, vec) for rows of T ticks: ``"row"`` or ``"warp"``, and
    whether it moves vector pieces (``aligned``: every pointer 16-byte
    aligned)."""
    if T <= ROW_MAX_T:
        return "row", aligned and T % 4 == 0
    return "warp", aligned and T % 2 == 0


def aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)
