"""Receivers — the system's input components (one per data source).

Each Receiver adapts to how the asset delivers data (MQTT push, HTTP poll,
AMQP queue). In this container the transports are simulated by
:class:`SimulatedDevice` objects generating timestamped readings at each
source's own reporting interval (the 5-min vs 1-h heterogeneity the paper
harmonizes); the Receiver/Translator code paths are identical to what a real
broker client would drive.

Per the paper's multi-environment design, a Receiver serves every
environment that subscribes to its source ("each Receiver allocates a
separate thread for every environment that requires data from that source").
"""
from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.runtime.records import CODECS


@dataclass
class SimulatedDevice:
    """A data source: reports `stream` every `interval_s` with noise, drop-
    outs (sensor turned off) and occasional spikes (the anomalies)."""
    stream: str
    interval_s: float
    base: float = 10.0
    amplitude: float = 2.0
    period_s: float = 3600.0
    noise: float = 0.2
    dropout_p: float = 0.05
    spike_p: float = 0.002
    spike_scale: float = 50.0
    jitter_s: float = 0.5
    seed: int = 0

    def readings(self, t_start: float, t_end: float, env_seed: int = 0):
        """Deterministic readings in [t_start, t_end) for reproducibility.

        All randomness is derived per-sample from ``hash((stream, seed,
        env_seed, k))`` so a poll's output depends only on the interval it
        covers, never on how many polls preceded it."""
        n0 = int(math.floor(t_start / self.interval_s))
        out = []
        k = n0
        while True:
            t = k * self.interval_s
            k += 1
            if t >= t_end:
                break
            if t < t_start:
                continue
            r = random.Random(hash((self.stream, self.seed, env_seed, k)))
            if r.random() < self.dropout_p:
                continue  # lost sample — gap filling's job
            v = self.base + self.amplitude * math.sin(2 * math.pi * t / self.period_s)
            v += r.gauss(0.0, self.noise)
            if r.random() < self.spike_p:
                v += self.spike_scale * (1 if r.random() < 0.5 else -1)
            out.append((t + r.uniform(0, self.jitter_s), v))
        return out


class Receiver(threading.Thread):
    """Polls/receives from one source and hands raw payloads to the
    Translator callback per subscribed environment.

    Two delivery shapes per subscription:
      * ``on_payload`` — one encoded wire payload per reading (the
        protocol-faithful path; exercises the codecs end to end).
      * ``on_batch``   — one ``(env_id, stream, ts_column, value_column,
        sorted_ts)`` call per poll (the columnar fast path: a poll's
        readings cross the receiver boundary as two NumPy columns plus a
        sortedness flag, no per-reading Python). ``sorted_ts`` is computed
        here — the receiver is the one place that sees the columns exactly
        once — and lets the Accumulator's sorted-merge close skip both its
        verification pass and its sort. Device jitter can reorder adjacent
        readings (jitter_s > interval_s), so the flag is measured, never
        assumed.
    When both are given the batch path wins; stats count logical readings
    either way (bytes on the batch path are the 16-byte binary-equivalent
    per reading, so load accounting stays comparable across paths).
    """

    def __init__(self, source_id: str, protocol: str, device: SimulatedDevice,
                 clock: Callable[[], float], speedup: float = 1.0,
                 max_backlog_s: float = 3600.0):
        super().__init__(daemon=True, name=f"receiver-{source_id}")
        self.source_id = source_id
        self.protocol = protocol
        self.device = device
        self.clock = clock
        self.speedup = speedup
        # QoS-0 semantics: when the consumer stalls (e.g. jit compiles), data
        # older than the backlog horizon is dropped, not replayed
        self.max_backlog_s = max_backlog_s
        self.encode = CODECS[protocol][0]
        self._subs: Dict[str, Optional[Callable[[str, bytes], None]]] = {}
        self._batch_subs: Dict[str, Callable] = {}
        self._stop = threading.Event()
        self._last_t: Dict[str, float] = {}
        # serializes poll cycles: the run() thread and synchronous
        # pump_receivers() callers both invoke poll_once, and an unguarded
        # read-emit-advance of _last_t double-emits (both see the same t0)
        # or drops (one overwrites the other's advance) readings
        self._poll_lock = threading.Lock()
        self.stats = {"payloads": 0, "bytes": 0}

    def subscribe(self, env_id: str,
                  on_payload: Optional[Callable[[str, bytes], None]] = None,
                  on_batch: Optional[Callable] = None):
        assert on_payload is not None or on_batch is not None
        with self._poll_lock:   # atomic wrt a concurrent poll cycle
            self._subs[env_id] = on_payload
            if on_batch is not None:
                self._batch_subs[env_id] = on_batch
            else:  # re-subscribing payload-only must drop a stale batch route
                self._batch_subs.pop(env_id, None)
            # first subscription starts the poll horizon NOW; a re-subscribe
            # keeps it, so any interval skipped while the subscription was
            # half-installed is delivered to the new callback instead of
            # silently dropped (max_backlog_s still bounds staleness)
            self._last_t.setdefault(env_id, self.clock())

    def unsubscribe(self, env_id: str) -> None:
        """Detach an env from this source (elastic membership).

        Atomic wrt a concurrent poll cycle; the poll horizon entry is
        dropped too, so a later re-subscribe of the same env id starts a
        FRESH horizon at attach time instead of replaying the gap."""
        with self._poll_lock:
            self._subs.pop(env_id, None)
            self._batch_subs.pop(env_id, None)
            self._last_t.pop(env_id, None)

    def poll_once(self):
        """One poll cycle: emit all new readings per environment.

        The whole cycle holds the receiver's poll lock, so concurrent
        ``start()``-thread polls and synchronous ``pump_receivers()`` calls
        interleave as atomic cycles over disjoint [t0, now) intervals —
        every reading is emitted exactly once."""
        with self._poll_lock:
            self._poll_cycle()

    def _poll_cycle(self):
        now = self.clock()
        for env_id, cb in list(self._subs.items()):
            t0 = max(self._last_t[env_id], now - self.max_backlog_s)
            if now <= t0:
                continue
            env_seed = abs(hash(env_id)) % 100000
            readings = self.device.readings(t0, now, env_seed)
            cb_batch = self._batch_subs.get(env_id)
            if cb_batch is not None:
                if readings:
                    ts = np.fromiter((r[0] for r in readings), np.float64,
                                     len(readings))
                    vs = np.fromiter((r[1] for r in readings), np.float64,
                                     len(readings))
                    self.stats["payloads"] += len(readings)
                    self.stats["bytes"] += 16 * len(readings)
                    srt = bool(np.all(ts[1:] >= ts[:-1]))
                    cb_batch(env_id, self.device.stream, ts, vs, srt)
            elif cb is None:
                # a half-installed subscription (e.g. a batch re-subscribe
                # that lost its route): keep _last_t so nothing is skipped
                # once a real callback lands, and never call None
                continue
            else:
                for ts, v in readings:
                    payload = self.encode(self.device.stream, ts, v)
                    self.stats["payloads"] += 1
                    self.stats["bytes"] += len(payload)
                    cb(env_id, payload)
            self._last_t[env_id] = now

    def run(self):
        while not self._stop.is_set():
            self.poll_once()
            time.sleep(max(self.device.interval_s / self.speedup / 4, 0.001))

    def stop(self):
        self._stop.set()
