"""Append-only log store — "All input data and model decisions are also
logged in a database, enabling future analysis and potential retraining."

JSONL segments with atomic rotation; env identities are stored anonymized
(salted hash, pseudonyms cached in a bounded LRU — ``anon_cache_size``
caps host memory under high-cardinality env ids; eviction only costs a
re-hash on the next append) per the paper's anonymization requirement.
A cursor (segment, offset) is exposed so the training node can consume
exactly-once.

Absolute times are float64 host values end-to-end here (the ``t`` column) —
the device-side replay ring stores int32 tick indices instead (see
``core.replay``); this log is where exact wall-clock time is preserved.

Accounting rules: ``stats["segments"]`` counts segments CREATED by this
instance (reopening an existing segment after ``close()`` or process
restart does not re-count), and rotation is driven by an explicitly
tracked byte total per segment — never ``tell()`` on the line-buffered
text handle, whose cookie is not a byte count on text streams.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Iterator, Optional

from repro_torch.core.replay import anonymize_env_ids


class LogDB:
    def __init__(self, root: str, salt: str = "percepta",
                 rotate_bytes: int = 8 * 2**20,
                 anon_cache_size: int = 4096):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.salt = salt
        self.rotate_bytes = rotate_bytes
        self._lock = threading.Lock()
        self._seg = self._latest_segment()
        self._fh = None
        self._seg_bytes = 0
        assert anon_cache_size >= 1, anon_cache_size
        self.anon_cache_size = int(anon_cache_size)
        self._anon_cache: OrderedDict = OrderedDict()
        # rows are encoded OUTSIDE the write lock (append_many), so the
        # LRU needs its own guard: a get/evict race on the shared
        # OrderedDict could move_to_end an already-evicted key
        self._anon_lock = threading.Lock()
        self.stats = {"rows": 0, "bytes": 0, "segments": 0}

    def _latest_segment(self) -> int:
        segs = sorted(self.root.glob("seg-*.jsonl"))
        return int(segs[-1].stem.split("-")[1]) if segs else 0

    def _anon(self, env_id: str) -> str:
        """Pseudonym lookup through the bounded LRU (hash is pure, so an
        evicted id simply re-hashes to the same pseudonym later)."""
        cache = self._anon_cache
        with self._anon_lock:
            p = cache.get(env_id)
            if p is not None:
                cache.move_to_end(env_id)
                return p
        p = anonymize_env_ids([env_id], self.salt)[0]   # hash outside lock
        with self._anon_lock:
            cache[env_id] = p
            if len(cache) > self.anon_cache_size:
                cache.popitem(last=False)      # evict least recently used
        return p

    def _open(self):
        if self._fh is None:
            path = self.root / f"seg-{self._seg:06d}.jsonl"
            fresh = not path.exists()
            self._fh = open(path, "a", buffering=1)
            # resume the byte count from disk when reopening an existing
            # segment so rotation still triggers at the true size
            self._seg_bytes = 0 if fresh else path.stat().st_size
            if fresh:
                self.stats["segments"] += 1

    def _write_locked(self, lines) -> None:
        """Caller holds the lock: write rows, account bytes, rotate once."""
        self._open()
        self._fh.write("".join(l + "\n" for l in lines))
        nb = sum(len(l) + 1 for l in lines)
        self.stats["rows"] += len(lines)
        self.stats["bytes"] += nb
        self._seg_bytes += nb
        if self._seg_bytes > self.rotate_bytes:
            self._fh.close()
            self._fh = None
            self._seg += 1

    def _row(self, env_id, tick_time, obs, action, reward, extra):
        row = {
            "env": self._anon(env_id),
            "t": float(tick_time),
            "obs": [float(x) for x in obs],
            "action": [float(x) for x in action],
            "reward": float(reward),
            "logged_at": time.time(),
        }
        if extra:
            row.update(extra)
        return json.dumps(row)

    def append(self, env_id: str, tick_time: float, obs, action, reward,
               extra: Optional[dict] = None):
        line = self._row(env_id, tick_time, obs, action, reward, extra)
        with self._lock:
            self._write_locked([line])

    def append_many(self, env_ids, tick_time: float, obs, actions, rewards,
                    extra: Optional[dict] = None):
        """One window across all envs in a single call: rows are encoded up
        front, the lock is taken ONCE, and rotation is checked once per
        batch (a segment may overshoot ``rotate_bytes`` by at most one
        batch). This is the batched-consume path's DB write — the host loop
        shrinks with the device loop."""
        lines = [self._row(env_id, tick_time, o, a, r, extra)
                 for env_id, o, a, r in zip(env_ids, obs, actions, rewards)]
        if not lines:
            return
        with self._lock:
            self._write_locked(lines)

    def read_from(self, segment: int = 0, offset: int = 0) -> Iterator[tuple]:
        """Yield (cursor, row) from the given cursor for retraining export."""
        for path in sorted(self.root.glob("seg-*.jsonl")):
            seg = int(path.stem.split("-")[1])
            if seg < segment:
                continue
            with open(path) as fh:
                for i, line in enumerate(fh):
                    if seg == segment and i < offset:
                        continue
                    yield (seg, i + 1), json.loads(line)

    def close(self):
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None
