"""Standardized record format + simulated source payload encodings.

Receivers produce raw protocol payloads; Translators parse them into
:class:`Record`s — the "standardized format" flowing to the env queues.

:class:`RecordBatch` is the columnar (structure-of-arrays) form of the same
standardized data: NumPy value/timestamp/stream-index columns plus a
stream-name table. It is what the fast ingest path moves through receivers,
queues, and the Accumulator — one Python object per poll instead of one per
reading, so batch assembly is O(records) vectorized NumPy with no
Python-level inner loop. A batch is exactly equivalent to the Record list
``to_records()`` returns (and the Accumulator treats them identically).
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Iterable, List, Sequence

import numpy as np


@dataclass(frozen=True)
class Record:
    env_id: str
    stream: str
    timestamp: float
    value: float


@dataclass(frozen=True)
class RecordBatch:
    """Columnar records for ONE environment (SoA mirror of ``List[Record]``).

    ``stream_ids`` indexes into the ``streams`` name table; ``timestamps``
    and ``values`` stay float64 so bucketing/sorting compares exactly like
    ``Record``'s Python floats (the float32 cast happens once, at window
    close, same as the per-record path). Row order is arrival order — the
    Accumulator's stable sorts rely on it for tie-breaking parity with the
    Record-list path.

    ``sorted_ts`` is the producer's sortedness promise: ``True`` means each
    stream's timestamp subsequence is non-decreasing (for a single-stream
    batch, simply that ``timestamps`` is non-decreasing), which lets the
    Accumulator's sorted-merge close skip its O(n) verification pass.
    ``None`` (default) means unknown — consumers verify cheaply on append.
    It must only be set ``True`` when actually true; ``False``/``None`` are
    always safe. Receivers compute it per poll; queue truncation preserves
    it (a prefix of a sorted column is sorted).
    """
    env_id: str
    streams: tuple                # stream-name table, indexed by stream_ids
    stream_ids: np.ndarray        # (N,) int32
    timestamps: np.ndarray        # (N,) float64
    values: np.ndarray            # (N,) float64
    sorted_ts: "bool | None" = None

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @staticmethod
    def from_columns(env_id: str, stream: str, timestamps, values,
                     sorted_ts: "bool | None" = None) -> "RecordBatch":
        """Single-stream batch (one Receiver poll of one device)."""
        ts = np.asarray(timestamps, np.float64).ravel()
        vs = np.asarray(values, np.float64).ravel()
        assert ts.shape == vs.shape
        return RecordBatch(env_id, (stream,),
                           np.zeros(ts.shape[0], np.int32), ts, vs,
                           sorted_ts)

    @staticmethod
    def from_records(records: Sequence[Record]) -> "RecordBatch":
        """Pack a homogeneous-env Record list (arrival order preserved)."""
        assert records, "empty record list"
        env_id = records[0].env_id
        table: dict = {}
        ids = np.empty(len(records), np.int32)
        ts = np.empty(len(records), np.float64)
        vs = np.empty(len(records), np.float64)
        for i, r in enumerate(records):
            assert r.env_id == env_id, "RecordBatch rows share one env"
            ids[i] = table.setdefault(r.stream, len(table))
            ts[i] = r.timestamp
            vs[i] = r.value
        return RecordBatch(env_id, tuple(table), ids, ts, vs)

    def to_records(self) -> List[Record]:
        return [Record(self.env_id, self.streams[int(s)], float(t), float(v))
                for s, t, v in zip(self.stream_ids, self.timestamps,
                                   self.values)]


def count_records(items: Iterable) -> int:
    """Number of records in a drained mix of Records and RecordBatches."""
    return sum(len(it) if isinstance(it, RecordBatch) else 1 for it in items)


# --- simulated wire formats (one per protocol family) -----------------------

def encode_mqtt_json(stream: str, ts: float, value: float) -> bytes:
    return json.dumps({"sensor": stream, "t": ts, "v": value}).encode()


def decode_mqtt_json(payload: bytes):
    d = json.loads(payload.decode())
    return d["sensor"], float(d["t"]), float(d["v"])


def encode_http_csv(stream: str, ts: float, value: float) -> bytes:
    return f"{stream},{ts:.3f},{value:.6f}".encode()


def decode_http_csv(payload: bytes):
    s, t, v = payload.decode().split(",")
    return s, float(t), float(v)


def encode_amqp_binary(stream: str, ts: float, value: float) -> bytes:
    name = stream.encode()[:32].ljust(32, b"\0")
    return name + struct.pack("<dd", ts, value)


def decode_amqp_binary(payload: bytes):
    name = payload[:32].rstrip(b"\0").decode()
    ts, v = struct.unpack("<dd", payload[32:48])
    return name, ts, v


CODECS = {
    "mqtt": (encode_mqtt_json, decode_mqtt_json),
    "http": (encode_http_csv, decode_http_csv),
    "amqp": (encode_amqp_binary, decode_amqp_binary),
}
