"""Per-environment internal queues (the RabbitMQ stand-in).

One queue per environment keeps environments isolated ("these environments
operate independently, do not interfere with each other").

Queue items are :class:`Record`s or columnar :class:`RecordBatch`es — the
stats count *records* either way, so one enqueued 500-row batch reads as
500 in ``enqueued``/``dequeued``, exactly like 500 individual puts.

Backpressure is RECORD-based too: ``maxsize`` bounds the number of buffered
*records*, not Python objects. The item-counting bound this replaces let a
columnar deployment buffer 100k RecordBatches — tens of millions of records
— before ever reporting Full, defeating the QoS-0 memory bound the Record
path enforces. A batch that does not fully fit is truncated: the prefix
that fits is enqueued (as a sliced RecordBatch) and the overflow rows are
counted in ``dropped`` — exactly the records the per-Record path would have
accepted and dropped, so the two ingest paths stay stats-identical under
overflow.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Union

from repro_torch.runtime.records import Record, RecordBatch

Item = Union[Record, RecordBatch]


def _n(item: Item) -> int:
    return len(item) if isinstance(item, RecordBatch) else 1


def _head(batch: RecordBatch, n: int) -> RecordBatch:
    """First ``n`` rows of a batch (arrival order preserved).

    The sortedness promise carries over: a prefix of a per-stream
    time-sorted batch is still per-stream time-sorted."""
    return RecordBatch(batch.env_id, batch.streams, batch.stream_ids[:n],
                       batch.timestamps[:n], batch.values[:n],
                       batch.sorted_ts)


class EnvQueue:
    """Thread-safe bounded queue; ``maxsize`` counts records."""

    def __init__(self, env_id: str, maxsize: int = 100_000):
        self.env_id = env_id
        self.maxsize = maxsize
        self._items: deque = deque()
        self._records = 0              # records currently buffered
        self._lock = threading.Lock()
        self.stats = {"enqueued": 0, "dropped": 0, "dequeued": 0}

    def put(self, item: Item) -> bool:
        """Enqueue; returns False when any record was dropped (QoS 0)."""
        n = _n(item)
        with self._lock:
            free = self.maxsize - self._records
            if n <= free:
                self._items.append(item)
                self._records += n
                self.stats["enqueued"] += n
                return True
            # overflow: accept the prefix that fits (record-path parity —
            # per-record puts would accept exactly `free` then drop), drop
            # the rest
            if free > 0 and isinstance(item, RecordBatch):
                self._items.append(_head(item, free))
                self._records += free
                self.stats["enqueued"] += free
            else:
                free = 0
            self.stats["dropped"] += n - free
            return False

    def drain(self, max_items: int = 1_000_000):
        out = []
        with self._lock:
            while self._items and len(out) < max_items:
                it = self._items.popleft()
                self._records -= _n(it)
                out.append(it)
            self.stats["dequeued"] += sum(_n(it) for it in out)
        return out

    def qsize(self):
        """Buffered ITEM count (see ``record_depth`` for the record count)."""
        return len(self._items)

    def record_depth(self):
        return self._records


class QueueBroker:
    """Routes records to environment queues; creates them on demand.

    ``maxsize`` is the per-env RECORD capacity handed to every queue this
    broker creates (the QoS-0 bound)."""

    def __init__(self, maxsize: int = 100_000):
        self.maxsize = maxsize
        self._queues: Dict[str, EnvQueue] = {}
        self._lock = threading.Lock()

    def queue_for(self, env_id: str) -> EnvQueue:
        with self._lock:
            if env_id not in self._queues:
                self._queues[env_id] = EnvQueue(env_id,
                                                maxsize=self.maxsize)
            return self._queues[env_id]

    def publish(self, item: Item):
        self.queue_for(item.env_id).put(item)

    def remove(self, env_id: str) -> int:
        """Drop an env's queue (elastic detach); returns discarded records."""
        with self._lock:
            q = self._queues.pop(env_id, None)
        return q.record_depth() if q is not None else 0

    def stats(self):
        # depth stays in records (enqueued - dequeued holds because both
        # count records); depth_items is the raw queue length, which is
        # smaller whenever multi-row RecordBatches are in flight
        return {e: q.stats | {"depth": q.record_depth(),
                              "depth_items": q.qsize()}
                for e, q in self._queues.items()}
