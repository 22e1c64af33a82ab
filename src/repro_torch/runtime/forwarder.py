"""Forwarders — decision delivery, one per destination system.

"If there is a smart light device that receives a 'turn on' decision, then
the decision is routed to the specific Forwarder associated with that
system. This Forwarder ensures the decision is formatted and transmitted
correctly."
"""
from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.runtime.records import CODECS


class Forwarder:
    """Formats and 'transmits' decisions for one destination (transport
    simulated by an in-memory sink; swap `transmit` for a real client)."""

    def __init__(self, dest_id: str, protocol: str, action_indices: Sequence[int],
                 transmit: Optional[Callable[[bytes], None]] = None):
        self.dest_id = dest_id
        self.protocol = protocol
        self.action_indices = list(action_indices)
        self.sink: List[bytes] = []
        self._transmit = transmit or self.sink.append
        self.stats = {"sent": 0, "bytes": 0}
        self._lock = threading.Lock()

    def _transmit_locked(self, payloads) -> None:
        # ONE lock acquisition per call (not per action index): sent/bytes
        # move together, so a pump-thread reader never observes a dispatch
        # half-counted, and batch dispatch isn't serialized on lock churn
        with self._lock:
            for payload in payloads:
                self._transmit(payload)
                self.stats["sent"] += 1
                self.stats["bytes"] += len(payload)

    def forward(self, env_id: str, tick_time: float, actions):
        encode = CODECS[self.protocol][0]
        self._transmit_locked([
            encode(f"{self.dest_id}/act{idx}", tick_time, float(actions[idx]))
            for idx in self.action_indices])

    def forward_window(self, tick_time: float, actions):
        """Batch dispatch one window: ``actions`` is (E, A), payloads for
        every (env, action index) are encoded up front in env-major order
        (matching E sequential ``forward`` calls), then transmitted under
        one lock acquisition. Like ``forward``, the wire topic carries only
        dest/action identity — env attribution lives in the LogDB rows."""
        encode = CODECS[self.protocol][0]
        self._transmit_locked([
            encode(f"{self.dest_id}/act{idx}", tick_time, float(a[idx]))
            for a in actions for idx in self.action_indices])


class ForwarderHub:
    def __init__(self, forwarders: Sequence[Forwarder]):
        self.forwarders = list(forwarders)

    def dispatch(self, env_id: str, tick_time: float, actions):
        for f in self.forwarders:
            f.forward(env_id, tick_time, actions)

    def dispatch_window(self, tick_time: float, actions):
        """One window across all envs (actions (E, A)); each forwarder's
        sink sees the same env order as per-env ``dispatch`` calls."""
        for f in self.forwarders:
            f.forward_window(tick_time, actions)
