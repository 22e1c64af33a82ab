"""Deterministic, resumable training-data pipeline — port of
``repro.data.pipeline``.

Batches come from a seeded synthetic LM stream. Every batch is a pure
function of (seed, batch index), drawn with ``numpy.random.RandomState``
exactly as the reference draws it, so both packages see the same batches,
index for index. The pipeline's position is one integer, the cursor,
saved in every checkpoint: a restart resumes at the saved batch.

:class:`Prefetcher` makes the next batch on a thread while the device
runs the current step: the arrays are staged into pinned host tensors
(where a card is the target) and copied to the device ``non_blocking``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class StreamCursor:
    batch_index: int = 0

    def state_dict(self):
        return {"batch_index": self.batch_index}

    @staticmethod
    def from_dict(d):
        return StreamCursor(batch_index=int(d.get("batch_index", 0)))


class SyntheticLMStream:
    """Deterministic pseudo-corpus: tokens from a per-batch seeded mix of
    topics with local repetition (so the next token is learnable); numpy
    arrays, int32 tokens and float32 frames or patches."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, frontend: str = "none", d_model: int = 0,
                 n_patches: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.frontend = frontend
        self.d_model = d_model
        self.n_patches = n_patches

    def make_batch(self, index: int) -> dict:
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % 2**31)
        n_topics = 8
        topic = rng.randint(0, n_topics, (self.batch,))
        base = (rng.randint(0, self.vocab // n_topics,
                            (self.batch, self.seq))
                + topic[:, None] * (self.vocab // n_topics)) % self.vocab
        rep = rng.rand(self.batch, self.seq) < 0.5
        shifted = np.roll(base, 1, axis=1)
        tokens = np.where(rep, shifted, base).astype(np.int32)
        if self.frontend == "embeddings":
            frames = rng.normal(0, 1, (self.batch, self.seq, self.d_model)
                                ).astype(np.float32)
            return {"frames": frames, "targets": tokens}
        if self.frontend == "vlm":
            st = self.seq - self.n_patches
            patches = rng.normal(0, 1, (self.batch, self.n_patches,
                                        self.d_model)).astype(np.float32)
            return {"tokens": tokens[:, :st], "patches": patches,
                    "targets": tokens[:, :st]}
        return {"tokens": tokens, "targets": tokens}


def to_device(batch: dict, device) -> dict:
    """numpy arrays -> tensors on ``device``: through pinned host memory
    and a ``non_blocking`` copy for a card, as they are for the CPU."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class Prefetcher:
    """One-batch-ahead prefetch: the batch at the cursor is made (and
    staged to ``device``) on a thread while the caller runs the previous
    one. :meth:`next` returns it and advances the cursor; on a card the
    caller's stream first waits for the copy (an event recorded after
    it). ``device=None`` hands out the numpy arrays."""

    def __init__(self, stream: SyntheticLMStream, cursor: StreamCursor,
                 device=None):
        self.stream = stream
        self.cursor = cursor
        self.device = None if device is None else torch.device(device)
        self._next = None
        self._event = None
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._prefetch()

    def _make(self, idx):
        batch = self.stream.make_batch(idx)
        if self.device is None:
            return batch
        batch = to_device(batch, self.device)
        if self.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()
        return batch

    def _prefetch(self):
        idx = self.cursor.batch_index

        def work():
            try:
                self._next = self._make(idx)
            except Exception as e:   # re-raised on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next(self) -> dict:
        self._thread.join()
        if self._error is not None:
            raise RuntimeError("batch prefetch failed") from self._error
        batch, event = self._next, self._event
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        self.cursor.batch_index += 1
        self._prefetch()
        return batch
