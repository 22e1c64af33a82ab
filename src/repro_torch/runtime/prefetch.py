"""WindowPrefetcher — port of ``repro.runtime.prefetch``: double-buffered
host-side window assembly.

The scan Manager loop alternates strictly: drain queues and build the
(K, E, S, M) batch on the host, then run the batch on the card and wait.
Here a pump thread assembles window batch *j+1* (clock advance -> receiver
poll -> queue drain -> ``Accumulator.close_windows`` -> a ``RawWindow`` on
the card) while the Manager runs batch *j*. With Python on both sides they
overlap only while one thread waits outside the interpreter (a copy, a
synchronization, a sleep).

Results equal the synchronous ``scan`` mode's bit for bit, by a
deterministic batch-epoch handoff:

  * the Manager submits :class:`BatchPlan` s (epoch-numbered window bounds,
    in order) on an unbounded task queue;
  * the pump thread is the only pumper/drainer in async modes and takes
    plans strictly in epoch order, with exactly the clock-advance / poll /
    drain sequence the synchronous loop runs at the same window
    boundaries, so every record lands in the same batch;
  * assembled batches come back through a depth-1 buffer (one batch on the
    card, at most one staged ahead), which also bounds host memory; at
    most three batches are alive at once (assembling, staged, in flight),
    which sizes the system's staging pool (``PerceptaSystem._STAGE_DEPTH``);
  * the Manager takes batches in epoch order and checks the tag of each;
  * every plan also carries the env-membership epoch it was built under,
    echoed on its batch, so an elastic system can check that no plan
    built before an attach, detach or resize is consumed after it
    (:meth:`WindowPrefetcher.in_flight` is 0 at a true batch boundary).

An exception in the pump thread (a CUDA error of its copy included) is
captured and re-raised in the Manager thread at the handoff, and the
prefetcher stays failed: nothing is swallowed or retried.
"""
from __future__ import annotations

import queue
import threading
from typing import List, NamedTuple, Optional, Tuple


class BatchPlan(NamedTuple):
    epoch: int                 # strictly increasing handoff tag
    bounds: List[Tuple[float, float]]
    pump: bool                 # advance the clock + poll receivers first
    membership: int = 0        # env-membership epoch the plan was built under


class AssembledBatch(NamedTuple):
    epoch: int
    bounds: List[Tuple[float, float]]
    raw: object                # RawWindow (K, E, S, M), window-relative ts
    counts: List[int]
    membership: int = 0        # echoed from the plan; the Manager checks it


class _PumpError(NamedTuple):
    epoch: int
    exc: BaseException


_STOP = object()


class WindowPrefetcher:
    """Owns the pump thread; one instance per system, started lazily.

    ``assemble(bounds, pump)`` is the system's callback that does the
    clock-advance/poll/drain/close work and returns ``(raw, counts)``;
    injecting it keeps this module free of system internals."""

    def __init__(self, assemble, depth: int = 1):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, not {depth}")
        self._assemble = assemble
        self._depth = depth
        self._tasks: "queue.Queue" = queue.Queue()
        self._ready: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_submit = 0      # next epoch to hand to the pump
        self._next_consume = 0     # next epoch the Manager must receive
        self._failed: Optional[BaseException] = None

    # --- lifecycle -----------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._pump_loop,
                                            name="window-prefetch",
                                            daemon=True)
            self._thread.start()

    def stop(self):
        """Stop the pump thread; safe to call repeatedly or when never run.

        Works when the Manager abandoned assembled batches (a consumer
        exception mid-run): the stop flag unblocks a pump waiting on the
        full ready buffer, and the queues and epoch counters reset, so a
        later :meth:`submit` starts from a clean handoff instead of
        replaying stale plans."""
        if self._thread is not None and self._thread.is_alive():
            self._stopping.set()
            self._tasks.put(_STOP)
            self._thread.join(timeout=10.0)
        self._thread = None
        self._stopping = threading.Event()
        self._tasks = queue.Queue()
        self._ready = queue.Queue(maxsize=self._depth)
        self._next_submit = 0
        self._next_consume = 0

    # --- Manager side --------------------------------------------------------
    def submit(self, bounds, pump: bool = True, membership: int = 0) -> int:
        """Queue one batch plan, tagged with the env-membership epoch it
        was built under; returns its epoch tag."""
        if self._failed is not None:
            raise RuntimeError("window prefetcher failed") from self._failed
        self._ensure_thread()
        epoch = self._next_submit
        self._next_submit += 1
        self._tasks.put(BatchPlan(epoch, list(bounds), pump, membership))
        return epoch

    def in_flight(self) -> int:
        """Plans submitted and not yet consumed (0 at a batch boundary)."""
        return self._next_submit - self._next_consume

    def next_batch(self, timeout: float = 600.0) -> AssembledBatch:
        """Block for the next assembled batch, checking the epoch handoff.

        Re-raises the exception the pump thread hit while assembling (the
        pump stops at its first failure, so the failed epoch is the one
        the Manager waits on)."""
        got = self._ready.get(timeout=timeout)
        if isinstance(got, _PumpError):
            self._failed = got.exc
            raise got.exc
        if got.epoch != self._next_consume:
            raise RuntimeError(f"epoch handoff violated: got {got.epoch}, "
                               f"expected {self._next_consume}")
        self._next_consume += 1
        return got

    # --- pump side -----------------------------------------------------------
    def _put_ready(self, item) -> bool:
        """Blocking put that stays responsive to :meth:`stop`: a Manager
        that abandons its batches must not wedge the pump on a full
        buffer."""
        while not self._stopping.is_set():
            try:
                self._ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _pump_loop(self):
        while not self._stopping.is_set():
            task = self._tasks.get()
            if task is _STOP:
                return
            try:
                raw, counts = self._assemble(task.bounds, task.pump)
            except BaseException as e:  # re-raised in the Manager thread
                self._put_ready(_PumpError(task.epoch, e))
                return
            if not self._put_ready(AssembledBatch(task.epoch, task.bounds,
                                                  raw, counts,
                                                  task.membership)):
                return
