"""Translators — per-source format adaptation to the standardized Record.

"Each data source also has an associated Translator that adjusts to the
format of the incoming data, extracting only the relevant information ...
and submits it to an internal queue associated with the appropriate
environment."

``translate`` is the per-payload path (decode one wire message -> one
Record). ``translate_batch`` is the columnar path: a whole receiver poll
(two NumPy columns) becomes one :class:`RecordBatch` with rename and unit
scaling applied vectorized.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.runtime.records import CODECS, Record, RecordBatch


class Translator:
    def __init__(self, source_id: str, protocol: str,
                 stream_rename: Optional[Dict[str, str]] = None,
                 unit_scale: float = 1.0):
        self.source_id = source_id
        self.decode = CODECS[protocol][1]
        self.stream_rename = stream_rename or {}
        self.unit_scale = unit_scale
        self.stats = {"records": 0, "errors": 0}

    def translate(self, env_id: str, payload: bytes) -> Optional[Record]:
        try:
            stream, ts, value = self.decode(payload)
        except Exception:
            self.stats["errors"] += 1
            return None
        self.stats["records"] += 1
        stream = self.stream_rename.get(stream, stream)
        return Record(env_id=env_id, stream=stream, timestamp=ts,
                      value=value * self.unit_scale)

    def translate_batch(self, env_id: str, stream: str, timestamps,
                        values,
                        sorted_ts: Optional[bool] = None
                        ) -> Optional[RecordBatch]:
        """Columnar poll -> one RecordBatch (rename + unit scale, no loop).

        The receiver already decoded/simulated the columns, so there is no
        per-row parse step to fail — malformed data is a per-payload-path
        concern, which is why ``errors`` only moves on ``translate``.
        ``sorted_ts`` (the receiver's measured sortedness promise) passes
        through untouched — rename and unit scaling never reorder rows.
        """
        ts = np.asarray(timestamps, np.float64)
        vs = np.asarray(values, np.float64)
        if ts.shape[0] == 0:
            return None
        if self.unit_scale != 1.0:
            vs = vs * self.unit_scale
        self.stats["records"] += int(ts.shape[0])
        stream = self.stream_rename.get(stream, stream)
        return RecordBatch.from_columns(env_id, stream, ts, vs, sorted_ts)
