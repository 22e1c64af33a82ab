"""tune_scan_params — port of ``repro.core.autotune``: a short measured
calibration of the scan engine's two free knobs.

``scan_k`` (windows per batch: fewer Python launches a window, more host
staging latency) and the env-mesh split (how many shards
``distribution.sharding.env_mesh`` spreads the E rows over) are picked by
measuring a small grid of real ``run_many`` batches on synthetic windows
(the numpy calibration batch of ``RandomState(seed)``, window-relative
timestamps and zero starts: the device-staging convention) and returning
the windows/s argmax. With ``decide=`` / ``decide_state=`` every cell
runs the fused engine (``run_many_decide``, sharded above one shard), so
the tuned cell is that of the engine that will run.

The same two pruning rules as the reference, deterministic under a fixed
``measure``: a split whose shards would hold fewer than
``min_envs_per_device`` rows is skipped outright, and once a cell is more
than ``prune_factor`` x slower than the best so far, the rest of its
split's K column is skipped. Skipped cells are listed on
:attr:`TuneResult.pruned`. Selection is the grid's argmax, the first in
grid order on a tie.

Timing is of the device work: a cell's ``fn`` ends in
``torch.cuda.synchronize`` on a card (the counterpart of
``block_until_ready``), and the default ``measure`` takes the best of
``reps`` after one warm-up call. This is the engine alone, with no source
simulation and no host assembly in the timed region.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence


class TuneResult(NamedTuple):
    """The chosen cell and the whole measured grid (in measure order)."""
    scan_k: int
    mesh_devices: int
    best_windows_per_s: float
    grid: tuple               # ((scan_k, mesh_devices, windows_per_s), ...)
    pruned: tuple = ()        # ((scan_k|None, mesh_devices, reason), ...)

    def as_dict(self) -> dict:
        return {"scan_k": self.scan_k, "mesh_devices": self.mesh_devices,
                "best_windows_per_s": round(self.best_windows_per_s, 1),
                "grid": [{"scan_k": k, "mesh_devices": n,
                          "windows_per_s": round(w, 1)}
                         for k, n, w in self.grid],
                "pruned": [{"scan_k": k, "mesh_devices": n, "reason": r}
                           for k, n, r in self.pruned]}


def candidate_device_counts(n_envs: int, n_devices: int) -> list:
    """Env-mesh splits worth measuring: device counts dividing E."""
    return [n for n in range(1, n_devices + 1) if n_envs % n == 0]


def _default_measure(fn: Callable[[], None], *, reps: int = 3, **_) -> float:
    """Best-of-``reps`` wall seconds of one call (a first call warms up
    and is not counted; the min is robust to one preempted rep on a shared
    host)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _clone(tree):
    from repro_torch.train import tree as tr
    return tr.map_(lambda x: x.clone(), tree)


def tune_scan_params(cfg, k_grid: Sequence[int] = (8, 16, 32),
                     device_counts: Optional[Sequence[int]] = None,
                     reps: int = 3, seed: int = 0, valid_p: float = 0.7,
                     measure: Optional[Callable] = None,
                     decide=None, decide_state=None,
                     min_envs_per_device: int = 2,
                     prune_factor: float = 3.0, device=None) -> TuneResult:
    """Measure windows/s over ``scan_k`` x env-mesh split and pick the best.

    ``cfg``: the deployment's ``PipelineConfig``. ``device_counts``
    defaults to every count of ``sharding.visible_devices(device)``
    dividing E (1 = the unsharded engine; N > 1 = the sharded one on
    ``env_mesh`` over the first N). ``measure(fn, k=..., n_devices=...,
    reps=...)`` returns seconds for one warmed call of ``fn``.
    ``decide``/``decide_state``: the fused engine's decision fns and a
    carry; each cell threads clones of the carry (ring included: the
    engine writes the ring in place), so the caller's carry is untouched.
    ``device=None`` means the CUDA card."""
    import numpy as np
    import torch

    from repro_torch.core.frame import make_raw_window
    from repro_torch.core.pipeline import (PerceptaPipeline, init_state,
                                           run_many_decide)
    from repro_torch.device import resolve_device
    from repro_torch.distribution import sharding as sh

    device = resolve_device(device)
    if measure is None:
        measure = _default_measure
    visible = sh.visible_devices(device)
    if device_counts is None:
        device_counts = candidate_device_counts(cfg.n_envs, len(visible))
    if (decide is None) != (decide_state is None):
        raise ValueError("decide and decide_state come as a pair")
    E, S, M = cfg.n_envs, cfg.n_streams, cfg.max_samples
    window_s = cfg.n_ticks * cfg.tick_s
    rng = np.random.RandomState(seed)
    kmax = max(k_grid)
    # one deterministic calibration batch, sliced per K
    values = rng.normal(5, 2, (kmax, E, S, M)).astype(np.float32)
    ts = rng.uniform(0, window_s, (kmax, E, S, M)).astype(np.float32)
    valid = rng.rand(kmax, E, S, M) < valid_p

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    grid, pruned = [], []
    best_wps = 0.0
    for ndev in device_counts:
        if ndev > 1 and E // ndev < min_envs_per_device:
            pruned.append((None, int(ndev),
                           f"envs_per_device<{min_envs_per_device}"))
            continue
        mesh = None
        if ndev > 1:
            mesh = sh.env_mesh(E, devices=visible[:ndev])
        if decide is not None:
            pipe = PerceptaPipeline(
                cfg, mode="scan_fused_decide_sharded" if mesh else
                "scan_fused_decide", device=device, decide=decide,
                elastic=decide_state.active is not None, mesh=mesh,
                decide_state=decide_state)
        else:
            pipe = PerceptaPipeline(cfg, mode="scan_sharded" if mesh
                                    else "scan", device=device, mesh=mesh)
        for i, k in enumerate(k_grid):
            raws = make_raw_window(values[:k], ts[:k], valid[:k],
                                   device=device)
            starts = torch.zeros((k, E), dtype=torch.float32, device=device)
            state = pipe.place_state(init_state(cfg, device))

            if decide is not None:
                # the engine writes the ring in place: thread clones of
                # the caller's carry through a cell-local loop
                cell = [state, pipe.place_decide(_clone(decide_state))]

                def fn(pipe=pipe, raws=raws, starts=starts, cell=cell):
                    with torch.no_grad():
                        cell[0], cell[1], _ = pipe.run_many_decide(
                            cell[0], cell[1], raws, starts)
                    wait()
            else:
                def fn(pipe=pipe, raws=raws, starts=starts, state=state):
                    with torch.no_grad():
                        pipe.run_many(state, raws, starts)
                    wait()

            secs = measure(fn, k=k, n_devices=ndev, reps=reps)
            wps = float(k) / float(secs)
            grid.append((int(k), int(ndev), wps))
            best_wps = max(best_wps, wps)
            if wps * prune_factor < best_wps:
                for k_rest in list(k_grid)[i + 1:]:
                    pruned.append((int(k_rest), int(ndev),
                                   f">{prune_factor:g}x_off_incumbent"))
                break

    if not grid:
        raise ValueError(
            "tune_scan_params: every requested mesh split was pruned "
            f"(device_counts={list(device_counts)}, n_envs={E}, "
            f"min_envs_per_device={min_envs_per_device}; pruned={pruned}). "
            "Include 1 in device_counts or lower min_envs_per_device.")
    best_k, best_n, best = max(grid, key=lambda row: row[2])
    return TuneResult(best_k, best_n, best, tuple(grid), tuple(pruned))
