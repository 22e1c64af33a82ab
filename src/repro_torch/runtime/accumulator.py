"""Accumulator — provider-agnostic per-environment collection.

"Each environment has its own dedicated Accumulator instance, which listens
to the corresponding queue. Upon receiving a message, it forwards the data
to the environment-specific Manager." Here the Accumulator also performs the
device-batch assembly: records -> padded (streams, max_samples) arrays with
validity masks for the window that just closed.

Storage is columnar and arena-staged: each stream owns a preallocated
growable (timestamp, value) float64 arena that ingest appends into in place
(geometric growth, no per-batch ``np.concatenate``), together with a
sortedness flag maintained on append. ``close_windows`` buckets ALL pending
records into the K requested windows with one ``searchsorted`` over each
stream's sorted arena — O(records) vectorized work and NO sort in the
steady state — while reproducing the per-record reference semantics
bit-for-bit: window k takes the not-yet-taken records with ts < t_end_k in
timestamp order (arrival order breaking ties), overflow beyond
``max_samples`` drops the OLDEST and is counted, records older than
t_start_k still occupy slots but are masked invalid, and records newer than
the last window end stay pending.

Sorted-merge parity argument (why skipping the global lexsort is safe): the
legacy path stable-lexsorts by ``(window, stream, ts)`` with arrival order
breaking ties. Records of DIFFERENT streams never share a lexsort group, so
only the within-stream arrival order matters for tie-breaks — which the
per-stream arenas preserve exactly (boolean-mask splits keep row order).
Within one stream, a stable argsort by ts reproduces the lexsort's group
ordering verbatim; when the arena is already sorted even that argsort is
skipped. The retained tail after a close is a suffix of a sorted column, so
arenas self-heal to sorted after every close regardless of how records
arrived. ``fastpath=False`` keeps the original chunk-list + global-lexsort
implementation alive for before/after benchmarking and parity tests.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.records import Record, RecordBatch

# one pending chunk = (stream_idx int32, ts float64, value float64) columns
Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray]

_MIN_ARENA = 256          # initial per-stream arena capacity (records)
_TABLE_CACHE_MAX = 256    # stream-index tables cached per accumulator


class Accumulator:
    def __init__(self, env_id: str, streams: Sequence[str], max_samples: int,
                 fastpath: bool = True):
        self.env_id = env_id
        self.streams = list(streams)
        self.stream_index = {s: i for i, s in enumerate(self.streams)}
        self.max_samples = max_samples
        self.fastpath = bool(fastpath)
        S = len(self.streams)
        # per-stream growable arenas (fast path): float64 ts/value columns,
        # fill counts, and "is this arena time-sorted" flags
        self._ts: List[np.ndarray] = [np.empty(0, np.float64)
                                      for _ in range(S)]
        self._vs: List[np.ndarray] = [np.empty(0, np.float64)
                                      for _ in range(S)]
        self._n: List[int] = [0] * S
        self._sorted: List[bool] = [True] * S
        # stream-name tuple -> stream-index table (ingest_batch no longer
        # rebuilds the mapping per call; batches reuse interned tuples)
        self._table_cache: dict = {}
        # legacy chunk list (fastpath=False)
        self._chunks: List[Chunk] = []
        self.stats = {"records": 0, "unknown_stream": 0, "overflow": 0}
        # fast-path observability, kept OUT of ``stats`` (which mirrors the
        # per-record reference accounting bit-for-bit): how often a close
        # segment skipped its sort vs had to sort / lexsort
        self.merge_stats = {"close_fast": 0, "close_sort": 0,
                            "close_lexsort": 0}

    # --- ingest ---------------------------------------------------------------
    def ingest(self, items: Sequence):
        """Accept a drained queue mix of ``Record``s and ``RecordBatch``es."""
        sid, ts, vs = [], [], []
        for it in items:
            if isinstance(it, RecordBatch):
                # flush interleaved singles first to preserve arrival order
                if sid:
                    self._push_columns(np.asarray(sid, np.int32),
                                       np.asarray(ts, np.float64),
                                       np.asarray(vs, np.float64))
                    sid, ts, vs = [], [], []
                self.ingest_batch(it)
                continue
            idx = self.stream_index.get(it.stream)
            if idx is None:
                self.stats["unknown_stream"] += 1
                continue
            sid.append(idx)
            ts.append(it.timestamp)
            vs.append(it.value)
        if sid:
            self._push_columns(np.asarray(sid, np.int32),
                               np.asarray(ts, np.float64),
                               np.asarray(vs, np.float64))

    def ingest_batch(self, batch: RecordBatch):
        """Columnar ingest: resolve the batch's stream table, drop unknowns."""
        n = len(batch)
        streams = batch.streams
        if self.fastpath and n and len(streams) == 1:
            # single-stream batch (every Receiver poll): no stream-id
            # indexing at all, straight append into that stream's arena
            idx = self.stream_index.get(streams[0])
            if idx is None:
                self.stats["unknown_stream"] += n
                return
            self.stats["records"] += n
            self._append_stream(idx,
                                np.asarray(batch.timestamps, np.float64),
                                np.asarray(batch.values, np.float64),
                                batch.sorted_ts)
            return
        table = self._table_cache.get(streams)
        if table is None:
            if len(self._table_cache) >= _TABLE_CACHE_MAX:
                self._table_cache.clear()
            table = np.asarray([self.stream_index.get(s, -1)
                                for s in streams], np.int32)
            self._table_cache[streams] = table
        sid = table[batch.stream_ids] if n else np.empty(0, np.int32)
        # float64 columns regardless of how the batch was built, so window
        # bucketing always compares like Record's Python floats
        ts = np.asarray(batch.timestamps, np.float64)
        vs = np.asarray(batch.values, np.float64)
        known = sid >= 0
        n_unknown = int((~known).sum())
        if n_unknown:
            self.stats["unknown_stream"] += n_unknown
            sid, ts, vs = sid[known], ts[known], vs[known]
        self._push_columns(sid, ts, vs)

    def _push_columns(self, sid: np.ndarray, ts: np.ndarray, vs: np.ndarray):
        """Store known-stream columns (arrival order) in the active store."""
        n = int(sid.shape[0])
        if not n:
            return
        self.stats["records"] += n
        if not self.fastpath:
            self._chunks.append((sid, ts, vs))
            return
        present = np.unique(sid)        # sorted; masks preserve row order
        if present.shape[0] == 1:
            self._append_stream(int(present[0]), ts, vs, None)
            return
        for s in present:
            m = sid == s
            self._append_stream(int(s), ts[m], vs[m], None)

    def _append_stream(self, s: int, ts: np.ndarray, vs: np.ndarray,
                       sorted_hint: Optional[bool]):
        """Append one stream's columns into its arena, growing geometrically.

        ``sorted_hint=True`` is a producer promise (``RecordBatch.sorted_ts``)
        that ``ts`` is non-decreasing — the O(n) verification is skipped.
        ``None``/``False`` verify, so a mis-flag can only cost a sort, never
        correctness.
        """
        n = int(ts.shape[0])
        if not n:
            return
        n0 = self._n[s]
        end = n0 + n
        if end > self._ts[s].shape[0]:
            cap = max(_MIN_ARENA, 2 * end)
            for cols in (self._ts, self._vs):
                grown = np.empty(cap, np.float64)
                grown[:n0] = cols[s][:n0]
                cols[s] = grown
        self._ts[s][n0:end] = ts
        self._vs[s][n0:end] = vs
        if self._sorted[s]:
            chunk_sorted = True if sorted_hint is True else (
                n < 2 or bool(np.all(ts[1:] >= ts[:-1])))
            self._sorted[s] = chunk_sorted and (
                n0 == 0 or ts[0] >= self._ts[s][n0 - 1])
        self._n[s] = end

    def reset(self) -> int:
        """Discard pending records (elastic detach); returns the count."""
        n = sum(int(c[0].shape[0]) for c in self._chunks) + sum(self._n)
        self._chunks = []
        self._n = [0] * len(self.streams)
        self._sorted = [True] * len(self.streams)
        return n

    def _pending(self) -> Chunk:
        if not self._chunks:
            z = np.empty(0)
            return np.empty(0, np.int32), z, z
        if len(self._chunks) > 1:
            self._chunks = [tuple(np.concatenate(cols)
                                  for cols in zip(*self._chunks))]
        return self._chunks[0]

    # --- window close ---------------------------------------------------------
    def close_window(self, t_start: float, t_end: float, rebase: bool = False):
        """Build the padded raw-window arrays for [t_start, t_end) and retain
        newer records for later windows."""
        v, ts, m = self.close_windows([(t_start, t_end)], rebase=rebase)
        return v[0], ts[0], m[0]

    def close_windows(self, bounds, rebase: bool = False, out=None):
        """Close K consecutive windows into stacked (K, S, M) arrays.

        ``bounds`` is a chronologically ordered sequence of (t_start, t_end)
        pairs; records newer than the last window end stay pending. Per
        stream, one ``searchsorted`` of the window ends into the sorted
        arena yields every window's contiguous record run (exactly the
        per-window "take everything with ts < t_end" of the reference
        loop); an unsorted arena first takes a stable argsort — identical
        ordering to the legacy global lexsort, see the module docstring.
        Overflow is trimmed from the oldest side, then values/timestamps/
        validity scatter in one shot.

        ``out=(values, ts, valid)`` writes into caller-provided PRE-ZEROED
        (K, S, M) arrays (may be strided views into a larger staging
        buffer) instead of allocating — the one-pass multi-env assembly
        path. The returned triple is ``out`` itself.

        ``rebase=True`` emits WINDOW-RELATIVE timestamps: each record's ts
        has its window's ``t_start`` subtracted in float64 *before* the
        float32 cast, so sub-second deltas stay exact on arbitrarily long
        horizons (absolute float32 seconds quantize to >=1s past t~2^24,
        ~194 days of stream time — minutes of wall time at high speedup).
        This is the device-staging form the scan/fused system modes consume
        (the pipeline receives ``window_start = 0``); all bucketing /
        ordering / validity decisions are made on the float64 absolute
        columns either way, so ``rebase`` changes only the emitted frame.
        """
        K, S, M = len(bounds), len(self.streams), self.max_samples
        if out is not None:
            values, ts_out, valid = out
        else:
            values = np.zeros((K, S, M), np.float32)
            ts_out = np.zeros((K, S, M), np.float32)
            valid = np.zeros((K, S, M), bool)
        starts = np.asarray([b[0] for b in bounds], np.float64)
        ends = np.asarray([b[1] for b in bounds], np.float64)
        if not self.fastpath:
            self._close_lexsort(starts, ends, rebase, values, ts_out, valid)
            return values, ts_out, valid

        for s in range(S):
            n = self._n[s]
            if not n:
                continue
            ts = self._ts[s][:n]
            vs = self._vs[s][:n]
            if self._sorted[s]:
                self.merge_stats["close_fast"] += 1
            else:
                order = np.argsort(ts, kind="stable")  # ties: arrival order
                ts = ts[order]
                vs = vs[order]
                self.merge_stats["close_sort"] += 1
            # cumulative take counts: records < ends[k] form the prefix
            # [0, cum[k]); equals bucket-by-searchsorted(ends, ts, "right")
            cum = np.searchsorted(ts, ends, side="left")
            taken = int(cum[-1])
            if taken:
                cnt = np.diff(cum, prepend=0)
                kb = np.repeat(np.arange(K), cnt)
                pos = np.arange(taken) - (cum - cnt)[kb]
                drop = np.maximum(cnt - M, 0)          # overflow: drop oldest
                n_drop = int(drop.sum())
                if n_drop:
                    self.stats["overflow"] += n_drop
                    dropb = drop[kb]
                    keep = pos >= dropb
                    slot = (pos - dropb)[keep]
                    kk = kb[keep]
                    tk = ts[:taken][keep]
                    vk = vs[:taken][keep]
                else:
                    slot, kk, tk, vk = pos, kb, ts[:taken], vs[:taken]
                values[kk, s, slot] = vk.astype(np.float32)
                tk_out = tk - starts[kk] if rebase else tk  # float64 subtract
                ts_out[kk, s, slot] = tk_out.astype(np.float32)
                valid[kk, s, slot] = tk >= starts[kk]
            rem = n - taken
            if rem:
                # sorted tail back to the arena front (numpy slice copies
                # handle the overlap); the arena is now sorted by
                # construction, healing any unsorted arrivals
                self._ts[s][:rem] = ts[taken:]
                self._vs[s][:rem] = vs[taken:]
            self._n[s] = rem
            self._sorted[s] = True
        return values, ts_out, valid

    def _close_lexsort(self, starts, ends, rebase, values, ts_out, valid):
        """Legacy close: one global stable lexsort over the chunk list.

        Kept verbatim behind ``fastpath=False`` as the bit-identity
        reference for tests and the before/after ingest benchmark.
        """
        K, S, M = ends.shape[0], len(self.streams), self.max_samples
        sid, ts, vs = self._pending()
        if not sid.shape[0]:
            return
        # window index: first k with ts < ends[k]; >= K stays pending
        bucket = np.searchsorted(ends, ts, side="right")
        taken = bucket < K
        self._chunks = [] if taken.all() else \
            [(sid[~taken], ts[~taken], vs[~taken])]
        sid, ts, vs, bucket = sid[taken], ts[taken], vs[taken], bucket[taken]
        if not sid.shape[0]:
            return
        # stable sort by (window, stream, ts) — ties keep arrival order,
        # matching the reference's stable per-stream list sort
        group = bucket.astype(np.int64) * S + sid
        order = np.lexsort((ts, group))
        group = group[order]
        sid, ts, vs, bucket = sid[order], ts[order], vs[order], bucket[order]
        self.merge_stats["close_lexsort"] += 1

        cnt = np.bincount(group, minlength=K * S)
        first = cnt.cumsum() - cnt                     # group start offsets
        pos = np.arange(group.shape[0]) - first[group]
        drop = np.maximum(cnt - M, 0)                  # overflow: drop oldest
        self.stats["overflow"] += int(drop.sum())
        keep = pos >= drop[group]
        slot = (pos - drop[group])[keep]
        kb, sb, tk, vk = bucket[keep], sid[keep], ts[keep], vs[keep]
        values[kb, sb, slot] = vk.astype(np.float32)
        tk_out = tk - starts[kb] if rebase else tk       # float64 subtract
        ts_out[kb, sb, slot] = tk_out.astype(np.float32)
        valid[kb, sb, slot] = tk >= starts[kb]
