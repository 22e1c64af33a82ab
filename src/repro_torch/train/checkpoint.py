"""Checkpointing: save/restore, async, atomic, keep-N — port of
``repro.train.checkpoint`` with the same on-disk layout:

    <dir>/step_<N>.tmp/            (written)
    <dir>/step_<N>/                (atomic rename on completion)
        manifest.json              step, time, leaf files/shapes/dtypes,
                                   the caller's ``extra``
        leaf_<i>.npy               one file per leaf

Leaves are numbered in ``jax.tree.flatten``'s order (``train.tree``: dicts
by sorted key), so a checkpoint written by either package restores in the
other, bit for bit. numpy has no bfloat16: the port saves such a leaf (an
LM's weights) as its raw 16-bit words, dtype ``bfloat16`` in the manifest,
and restores it by that name. float16 (a float16 model's weights) is a
numpy dtype and is saved as it is, ``float16`` in the manifest, as the
reference saves it.

A sharded run saves its trees gathered (``sharding.gather_tree``): the
leaves are global tensors, so a checkpoint from a (2, 4) mesh restores
onto a (4, 2) or a (1, 1) one, or onto one device.

Fault-tolerance contract:
  * the atomic rename means a crash mid-write never corrupts the latest
    checkpoint: restore picks the newest COMPLETE step directory;
  * async mode hands host copies to a writer thread, so the caller resumes
    at once. The copies are made on the calling thread before the save
    returns, so a tensor written in place later (a ring, a carry) cannot
    change what is saved.

:meth:`Checkpointer.flush` waits until every queued write is on disk
(``queue.join``); the reference polls ``empty()`` and then sleeps, which
can return while one write is still in flight.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train import tree


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _host(x: torch.Tensor):
    """A private host copy of one leaf and its dtype's name. numpy has no
    bfloat16: such a leaf is saved as its raw 16-bit words and named
    ``bfloat16`` in the manifest."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
    arr = x.numpy().copy()
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_mode: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_mode = async_mode
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        if async_mode:
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="ckpt-writer")
            self._worker.start()

    # ------------------------------------------------------------------ save
    def save(self, step: int, t: Any, *, extra: Optional[dict] = None,
             block: bool = False):
        """Copy the leaves to the host, then write (async by default)."""
        self._raise_if_failed()
        payload = (step, [_host(x) for x in tree.leaves(t)], extra or {})
        if self.async_mode and not block:
            self._q.put(payload)
        else:
            self._write(*payload)

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except Exception as e:  # surfaced by the next save() / flush()
                self._err = e
            finally:
                self._q.task_done()

    def _raise_if_failed(self):
        if self._err:
            raise RuntimeError("checkpoint writer died") from self._err

    def _write(self, step: int, host_leaves, extra: dict):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": [],
                    "extra": extra}
        for i, (arr, dtype) in enumerate(host_leaves):
            np.save(tmp / _leaf_name(i), arr)
            manifest["leaves"].append({"file": _leaf_name(i),
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        with open(tmp / "manifest.json", "w") as fh:
            json.dump(manifest, fh)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self.dir.glob("step_????????"))
        for old in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(old, ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = sorted(self.dir.glob("step_????????"))
        for cand in reversed(steps):
            if (cand / "manifest.json").exists():
                return int(cand.name.split("_")[1])
        return None

    def restore(self, step: int, like: Any, shardings=None):
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf comes back on its ``like`` leaf's device with the saved dtype.
        ``shardings=(specs, mesh)`` places the restored global tree on the
        current mesh (``distribution.sharding.place_tree``, one tree per
        shard), whatever mesh saved it: the checkpoint holds global
        tensors. Returns ``(tree, extra)``."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat, treedef = tree.flatten(like)
        if len(manifest["leaves"]) != len(flat):
            raise ValueError(f"checkpoint has {len(manifest['leaves'])} "
                             f"leaves, the tree {len(flat)}")
        out = []
        for i, (meta, ref) in enumerate(zip(manifest["leaves"], flat)):
            arr = np.load(d / meta["file"])
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, "
                                 f"tree shape {tuple(ref.shape)}")
            out.append(_tensor(arr, meta["dtype"]).to(ref.device))
        restored = tree.unflatten(treedef, out)
        if shardings is not None:
            from repro_torch.distribution import sharding
            specs, mesh = shardings
            restored = sharding.place_tree(restored, specs, mesh, copy=True)
        return restored, manifest["extra"]

    def flush(self):
        """Wait until every queued write is on disk."""
        if self.async_mode:
            self._q.join()
        self._raise_if_failed()

    def close(self):
        if self.async_mode and self._worker is not None:
            self.flush()
            self._q.put(None)
            self._worker.join(timeout=10)
            self._worker = None
