"""PerceptaSystem — port of ``repro.runtime.system`` for the ``fused``,
``scan``, ``scan_fused_decide``, ``scan_async`` and
``scan_fused_decide_async`` Manager loops.

All environments are rows of the batched device pipeline; isolation is by
construction (per-env queues, per-env state rows, per-env model slots).
Time is virtual (``speedup``, or ``manual_time`` for deterministic runs).

``mode="fused"``: :meth:`run_window` closes each env's window, runs one
pipeline tick and one ``Predictor.on_tick``, forwards the decisions and
logs them. ``mode="scan"``: queues are drained once per batch, each env's
Accumulator closes K consecutive windows straight into (K, E, S, M)
staging buffers, one ``PerceptaPipeline.run_many`` processes the batch on
the device, and one ``Predictor.on_windows`` consumes it; host sinks see
one result row per window, in window order, bit-identical to ``fused``.

``mode="scan_fused_decide"``: the Predictor's per-window step (policy,
``validate_actions``, reward) runs inside the pipeline's K loop
(``PerceptaPipeline.run_many_decide``), the decision state
(``predictor.DecideState``) is carried on the device beside the pipeline
state, and the K replay transitions are banked once per batch. Consume
fetches only actions, rewards, violation flags and exact per-env
observed/filled/anomalous counts, plus the (K, E, F) features when a LogDB
is attached; the (K, E, S, T) frames stay on the card. Results equal
``scan``'s bit for bit. Accessor rule: the system's ``DecideState`` is
authoritative for the decision carry (prev obs and actions, tick, model
carry); the Predictor's own copies of those stop following it. The replay
ring is shared: the carry's ``replay`` IS the Predictor's ring, written in
place by each batch, and ``Predictor.absorb_fused`` keeps its float64 time
mirror in step, so :meth:`export_replay` and :meth:`replay_size` read the
Predictor in every mode. :meth:`snapshot_decide` clones the carry.

``mode="scan_async"`` / ``"scan_fused_decide_async"``: the same loops with
host assembly pipelined against the Manager (``runtime.prefetch``): a pump
thread advances the clock, polls the receivers, drains and closes batch
j+1 while the Manager runs batch j; the Manager consumes batch j-1 before
it launches batch j. Results equal the synchronous twin's bit for bit. The
pump's copy to the card goes on the default stream, behind the Manager's
queued work, and from a private host copy of the staging buffers
(``make_raw_window`` copies first, and a copy from pageable memory has
read its source when it returns), so a staging buffer is free for reuse
as soon as ``assemble_windows`` returns.
On the card these modes are currently SLOWER than their synchronous twins:
the pump and the Manager's thousands of launches a batch are both Python
and take turns on the interpreter rather than overlapping (PERF.md §6).

Device-visible time is WINDOW-RELATIVE: the Accumulator subtracts each
window's start in float64 before the float32 cast, every dispatch receives
``window_start = 0``, and the seasonal phase survives through the exact
integer ``PipelineConfig.tick0``. Absolute times stay host float64.

``train="online"`` (fused-decide modes only; ``train_cfg`` passes through
to it) attaches a ``runtime.trainer.OnlineTrainer``: one sample + AdamW
step per K-window batch, launched right after the decide batch on the same
stream. Hot-swaps land only at batch boundaries (``apply_pending`` swaps
the carry's ``policy``/``version`` leaves before the next launch),
``policy_version`` rises by one per applied step, and every replay row
and LogDB row carries the version that produced its action. With training
off, or before the first applied step, the decide path is bit-identical
to the untrained fused modes. Accessors: :meth:`policy_version`,
:meth:`snapshot_policy`, :meth:`train_stats`, :meth:`restore_training`.

Not ported yet, and refused with a ``ValueError`` naming the ROADMAP item:
the ``_sharded`` modes, ``elastic`` and ``scan_k="auto"``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import PerceptaPipeline, PipelineConfig
from repro_torch.core.frame import make_raw_window
from repro_torch.device import resolve_device
from repro_torch.runtime.accumulator import Accumulator
from repro_torch.runtime.forwarder import ForwarderHub
from repro_torch.runtime.predictor import Predictor
from repro_torch.runtime.prefetch import WindowPrefetcher
from repro_torch.runtime.queues import QueueBroker
from repro_torch.runtime.receivers import Receiver, SimulatedDevice
from repro_torch.runtime.records import RecordBatch, count_records
from repro_torch.runtime.translator import Translator

# Manager-loop mode -> device-pipeline mode: the async modes reuse the
# scan engines and differ only in how the Manager overlaps host assembly
_PIPELINE_MODE = {
    "fused": "fused",
    "scan": "scan",
    "scan_async": "scan",
    "scan_fused_decide": "scan_fused_decide",
    "scan_fused_decide_async": "scan_fused_decide",
}
_ASYNC_MODES = ("scan_async", "scan_fused_decide_async")
_NOT_PORTED_MODES = {
    "scan_sharded": "ROADMAP.md queue 1 item 12 (multi-device)",
    "scan_async_sharded": "ROADMAP.md queue 1 item 12 (multi-device)",
    "scan_fused_decide_sharded": "ROADMAP.md queue 1 item 12 (multi-device)",
    "scan_fused_decide_async_sharded":
        "ROADMAP.md queue 1 item 12 (multi-device)",
}


@dataclass
class SourceSpec:
    source_id: str
    protocol: str                 # mqtt | http | amqp
    device: SimulatedDevice
    unit_scale: float = 1.0


class PerceptaSystem:
    def __init__(self, env_ids: Sequence[str], sources: Sequence[SourceSpec],
                 pipeline_cfg: PipelineConfig, predictor: Predictor,
                 forwarders: Optional[ForwarderHub] = None, db=None,
                 mode: str = "fused", speedup: float = 60.0,
                 t0: float = 0.0, manual_time: bool = False,
                 scan_k=8, ingest: str = "columnar",
                 train: Optional[str] = None,
                 train_cfg: Optional[dict] = None, policy=None,
                 env_slots: Optional[int] = None, elastic: bool = False,
                 ingest_workers: int = 1, ingest_fastpath: bool = True,
                 device=None):
        if mode in _NOT_PORTED_MODES:
            raise ValueError(f"mode {mode!r} is not ported yet: "
                             f"{_NOT_PORTED_MODES[mode]}")
        if mode not in _PIPELINE_MODE:
            raise ValueError(f"unknown mode {mode!r}")
        if elastic or (env_slots is not None and env_slots != len(env_ids)):
            raise ValueError("elastic env pools are not ported yet: "
                             "ROADMAP.md queue 1 item 10")
        if train is not None and train != "online":
            raise ValueError(f"unknown train mode {train!r} "
                             "(expected None or 'online')")
        if train is not None and _PIPELINE_MODE[mode] != "scan_fused_decide":
            raise ValueError(
                "train='online' rides the fused decide carry: use a "
                f"scan_fused_decide* mode, not {mode!r}")
        if scan_k == "auto":
            raise ValueError("scan_k='auto' is not ported yet: "
                             "ROADMAP.md queue 1 item 12 (autotune)")
        self.device = resolve_device(device)
        if predictor.device != self.device:
            raise ValueError(f"predictor lives on {predictor.device}, the "
                             f"system on {self.device}")
        if pipeline_cfg.n_envs != len(env_ids):
            raise ValueError("pipeline_cfg.n_envs must equal len(env_ids)")
        if pipeline_cfg.n_streams != len(sources):
            raise ValueError("pipeline_cfg.n_streams must equal "
                             "len(sources)")
        if ingest not in ("columnar", "records"):
            raise ValueError(f"unknown ingest {ingest!r}")
        # manual_time: the virtual clock only advances when run_windows
        # closes a window — deterministic whatever the host's stalls
        self.manual_time = manual_time
        self._manual_t = t0
        self.env_ids = list(env_ids)
        self.sources = list(sources)
        # bake the absolute tick origin in (exact integer seasonal phase
        # under window-relative device timestamps; see core.pipeline)
        pipeline_cfg = dataclasses.replace(
            pipeline_cfg, tick0=int(round(t0 / pipeline_cfg.tick_s)))
        self.cfg = pipeline_cfg
        self.mode = mode
        pipe_mode = _PIPELINE_MODE[mode]
        self.fused_decide = pipe_mode == "scan_fused_decide"
        if policy is not None:
            predictor.set_model(policy)
        # fused-decide: the Predictor hands its decision state over as the
        # device carry and only keeps host bookkeeping (absorb_fused)
        decide = predictor.make_decide_fn() if self.fused_decide else None
        self._dstate = predictor.decide_state() if self.fused_decide \
            else None
        self.scan_k = max(1, int(scan_k))
        self.ingest = ingest
        self.ingest_fastpath = bool(ingest_fastpath)
        # ingest_workers=N: assemble_windows partitions the envs over N
        # persistent threads with slot-striped ownership; per-env work
        # touches disjoint staging columns, so results are bit-identical
        self.ingest_workers = max(1, int(ingest_workers))
        self._ingest_pool = None
        if self.ingest_workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._ingest_pool = ThreadPoolExecutor(
                max_workers=self.ingest_workers,
                thread_name_prefix="percepta-ingest")
        self._stage_pool: Dict[tuple, dict] = {}
        self.pipeline = PerceptaPipeline(pipeline_cfg, mode=pipe_mode,
                                         device=self.device, decide=decide)
        self.state = self.pipeline.init_state()
        self._prefetcher: Optional[WindowPrefetcher] = None
        self.predictor = predictor
        # train="online": retraining on the device between the fused decide
        # launches (runtime.trainer); train_cfg holds OnlineTrainer's
        # keyword arguments (batch_size, train_cfg, seed, checkpoint_dir,
        # checkpoint_every)
        self.trainer = None
        if train is not None:
            from repro_torch.runtime.trainer import OnlineTrainer
            self.trainer = OnlineTrainer(predictor, **dict(train_cfg or {}))
        self.forwarders = forwarders
        self.db = db
        self.speedup = speedup
        self._wall0 = time.time()
        self._t0 = t0
        self.window_s = pipeline_cfg.n_ticks * pipeline_cfg.tick_s
        self.window_index = 0

        self.broker = QueueBroker()
        self.translators = {
            s.source_id: Translator(s.source_id, s.protocol,
                                    unit_scale=s.unit_scale)
            for s in sources
        }
        self.receivers: List[Receiver] = [
            Receiver(s.source_id, s.protocol, s.device, self.now,
                     speedup=speedup) for s in sources]
        self._stream_names = [s.device.stream for s in sources]
        self.accumulators: Dict[str, Accumulator] = {}
        for env in env_ids:
            self._register_env(env)
        self.metrics: Dict[str, list] = {"tick_latency_s": [],
                                         "ingest_records": []}

    def _register_env(self, env_id: str) -> None:
        """Wire one env into every source Receiver and give it its own
        Accumulator."""
        for r in self.receivers:
            tr = self.translators[r.source_id]

            def on_payload(env_id, payload, _tr=tr):
                rec = _tr.translate(env_id, payload)
                if rec is not None:
                    self.broker.publish(rec)

            def on_batch(env_id, stream, ts, vals, srt=None, _tr=tr):
                batch = _tr.translate_batch(env_id, stream, ts, vals, srt)
                if batch is not None:
                    self.broker.publish(batch)

            if self.ingest == "columnar":
                r.subscribe(env_id, on_batch=on_batch)
            else:
                r.subscribe(env_id, on_payload)
        self.accumulators[env_id] = Accumulator(env_id, self._stream_names,
                                                self.cfg.max_samples,
                                                fastpath=self.ingest_fastpath)

    # --- virtual clock -------------------------------------------------------
    def now(self) -> float:
        if self.manual_time:
            return self._manual_t
        return self._t0 + (time.time() - self._wall0) * self.speedup

    def window_bounds(self, index: Optional[int] = None):
        idx = self.window_index if index is None else index
        start = self._t0 + idx * self.window_s
        return start, start + self.window_s

    # --- threaded operation ---------------------------------------------------
    def start(self):
        for r in self.receivers:
            r.start()

    def stop(self):
        for r in self.receivers:
            r.stop()
        if self._prefetcher is not None:
            self._prefetcher.stop()
        if self.trainer is not None:
            self.trainer.close()
        if self._ingest_pool is not None:
            self._ingest_pool.shutdown(wait=True)
            self._ingest_pool = None

    # --- synchronous operation -----------------------------------------------
    def pump_receivers(self):
        for r in self.receivers:
            r.poll_once()

    def run_window(self) -> dict:
        """Process one closed window across all environments."""
        t_start, t_end = self.window_bounds()
        E, S, M = self.cfg.n_envs, self.cfg.n_streams, self.cfg.max_samples

        n_new = 0
        for env in self.env_ids:
            recs = self.broker.queue_for(env).drain()
            n_new += count_records(recs)
            self.accumulators[env].ingest(recs)

        values = np.zeros((E, S, M), np.float32)
        ts = np.zeros((E, S, M), np.float32)
        valid = np.zeros((E, S, M), bool)
        for i, env in enumerate(self.env_ids):
            v, t, m = self.accumulators[env].close_window(t_start, t_end,
                                                          rebase=True)
            values[i], ts[i], valid[i] = v, t, m

        t_proc0 = time.time()
        raw = make_raw_window(values, ts, valid, device=self.device)
        # window-relative time: the device sees window_start = 0; absolute
        # time stays host-side (t_end below)
        with torch.no_grad():
            self.state, feats, frame = self.pipeline.run_tick(
                self.state, raw, torch.zeros((E,), dtype=torch.float32,
                                             device=self.device))
        actions, rewards, _ = self.predictor.on_tick(
            feats.features, t_end, raw=feats.raw)
        latency = time.time() - t_proc0

        if self.forwarders is not None:
            for i, env in enumerate(self.env_ids):
                self.forwarders.dispatch(env, t_end, actions[i])
        if self.db is not None:
            obs = feats.features.cpu().numpy()
            ver = int(self.predictor.policy_version)
            for i, env in enumerate(self.env_ids):
                self.db.append(env, t_end, obs[i], actions[i],
                               float(rewards[i]),
                               extra={"policy_version": ver})

        self.window_index += 1
        self.metrics["tick_latency_s"].append(latency)
        self.metrics["ingest_records"].append(n_new)
        return {
            "window": self.window_index - 1,
            "records": n_new,
            "latency_s": latency,
            "mean_reward": float(np.mean(rewards)),
            "observed_frac": float(frame.observed.cpu().numpy().mean()),
            "filled_frac": float(frame.filled.cpu().numpy().mean()),
            "anomalous": int(frame.anomalous.cpu().numpy().sum()),
        }

    # --- scan operation --------------------------------------------------------
    # Rotating staging buffers: make_raw_window copies each batch out of
    # them, so reuse is safe at any depth; three keeps the reference's
    # rotation (the async modes hold up to three batches alive).
    _STAGE_DEPTH = 3

    def _staging_buffers(self, K: int, E: int):
        """Rotating preallocated (K, E, S, M) staging triple, zeroed."""
        S, M = self.cfg.n_streams, self.cfg.max_samples
        pool = self._stage_pool.setdefault((K, E, S, M),
                                           {"bufs": [], "next": 0})
        i = pool["next"]
        pool["next"] = (i + 1) % self._STAGE_DEPTH
        if i >= len(pool["bufs"]):
            shape = (K, E, S, M)
            pool["bufs"].append((np.zeros(shape, np.float32),
                                 np.zeros(shape, np.float32),
                                 np.zeros(shape, bool)))
        else:
            for a in pool["bufs"][i]:
                a.fill(0)
        return pool["bufs"][i]

    def _assemble_env(self, slot: int, env: str, bounds, starts,
                      values, ts, valid) -> np.ndarray:
        """Drain, count, ingest and close ONE env into its staging rows
        (the unit of work ``ingest_workers`` partitions)."""
        K = len(bounds)
        recs = self.broker.queue_for(env).drain()
        c = np.zeros(K, np.int64)
        scalar_ts = []
        for r in recs:
            if isinstance(r, RecordBatch):
                j = np.searchsorted(starts, r.timestamps, side="right") - 1
                c += np.bincount(np.clip(j, 0, K - 1), minlength=K)
            else:
                scalar_ts.append(r.timestamp)
        if scalar_ts:
            j = np.searchsorted(starts, np.asarray(scalar_ts),
                                side="right") - 1
            c += np.bincount(np.clip(j, 0, K - 1), minlength=K)
        acc = self.accumulators[env]
        acc.ingest(recs)
        acc.close_windows(bounds, rebase=True,
                          out=(values[:, slot], ts[:, slot], valid[:, slot]))
        return c

    def assemble_windows(self, bounds) -> tuple:
        """Drain queues once and stack K closed windows per env straight
        into the (K, E, S, M) staging buffers, then copy the batch to the
        device. Returns ``(RawWindow with leading K axis, per-window record
        counts)``; each drained record is attributed to the window whose
        bounds contain its timestamp (clipped to the batch)."""
        E = self.cfg.n_envs
        K = len(bounds)
        starts = np.asarray([b[0] for b in bounds], np.float64)
        live = list(enumerate(self.env_ids))
        values, ts, valid = self._staging_buffers(K, E)
        counts_arr = np.zeros(K, np.int64)
        if self._ingest_pool is not None and len(live) > 1:
            def run_shard(shard):
                return [self._assemble_env(i, env, bounds, starts,
                                           values, ts, valid)
                        for i, env in shard]
            shards = [live[w::self.ingest_workers]
                      for w in range(self.ingest_workers)]
            futs = [self._ingest_pool.submit(run_shard, sh)
                    for sh in shards if sh]
            for f in futs:
                for c in f.result():
                    counts_arr += c
        else:
            for i, env in live:
                counts_arr += self._assemble_env(i, env, bounds, starts,
                                                 values, ts, valid)
        counts = [int(c) for c in counts_arr]
        return make_raw_window(values, ts, valid, device=self.device), counts

    def run_windows_scan(self, k: int) -> List[dict]:
        """Process the next ``k`` windows with one pipeline batch."""
        bounds = [self.window_bounds(self.window_index + j) for j in range(k)]
        raw, counts = self.assemble_windows(bounds)
        return self._consume_batch(self._dispatch_batch(bounds, counts,
                                                        raw))

    def _dispatch_scan(self, raw, k: int):
        """Run ONE ``run_many`` over a staged K-window batch (enqueued on
        the device; consumption synchronizes)."""
        t_dispatch = time.time()
        # each window's samples were rebased to its own start, so every
        # step sees start = 0
        starts = torch.zeros((k, self.cfg.n_envs), dtype=torch.float32,
                             device=self.device)
        with torch.no_grad():
            self.state, feats, frames = self.pipeline.run_many(
                self.state, raw, starts)
        return feats, frames, t_dispatch

    def _consume_scan(self, bounds, counts, feats, frames,
                      t_dispatch) -> List[dict]:
        """Run the batch's host side (Predictor, Forwarders, DB, metrics)
        in window order: one ``Predictor.on_windows`` over the stacked
        features, then per-window numpy slices for the sinks."""
        k = len(bounds)
        actions_b, rewards_b, _ = self.predictor.on_windows(
            feats.features, [b[1] for b in bounds], raw=feats.raw)
        batch_latency = time.time() - t_dispatch
        # one batch-wide host transfer per leaf; the per-window loop
        # slices numpy
        feat_np = feats.features.cpu().numpy()
        obs_np = frames.observed.cpu().numpy()
        fill_np = frames.filled.cpu().numpy()
        anom_np = frames.anomalous.cpu().numpy()
        out = []
        for j, (t_start, t_end) in enumerate(bounds):
            t_host0 = time.time()
            actions, rewards = actions_b[j], rewards_b[j]
            if self.forwarders is not None:
                self.forwarders.dispatch_window(t_end, actions)
            if self.db is not None:
                self.db.append_many(self.env_ids, t_end, feat_np[j], actions,
                                    rewards,
                                    extra={"policy_version":
                                           int(self.predictor.policy_version)})
            self.window_index += 1
            # amortized device + predictor share of the batch plus this
            # window's host work (comparable to run_window's latency_s)
            latency = batch_latency / k + (time.time() - t_host0)
            self.metrics["tick_latency_s"].append(latency)
            self.metrics["ingest_records"].append(counts[j])
            out.append({
                "window": self.window_index - 1,
                "records": counts[j],
                "latency_s": latency,
                "mean_reward": float(np.mean(rewards)) if rewards.size
                               else 0.0,
                "observed_frac": float(obs_np[j].mean())
                                 if obs_np[j].size else 0.0,
                "filled_frac": float(fill_np[j].mean())
                               if fill_np[j].size else 0.0,
                "anomalous": int(anom_np[j].sum()),
            })
        return out

    # --- fused-decide operation ------------------------------------------------
    def _dispatch_decide(self, raw, k: int):
        """Run ONE ``run_many_decide`` over a staged K-window batch: the
        pipeline state and the decision carry stay on the device, and
        nothing is read back here but the trainer's one scalar.

        With a trainer this is the batch boundary: the previous step's
        result swaps the carry's policy/version leaves BEFORE the launch
        (the whole batch runs one policy), and a new step is launched
        right AFTER it, on the same stream. Returns ``(outs, t_dispatch,
        policy_version)`` with the version that produced this batch's
        actions."""
        if self.trainer is not None:
            self._dstate = self.trainer.apply_pending(self._dstate)
        ver = int(self.predictor.policy_version)
        t_dispatch = time.time()
        starts = torch.zeros((k, self.cfg.n_envs), dtype=torch.float32,
                             device=self.device)
        with torch.no_grad():
            self.state, self._dstate, outs = self.pipeline.run_many_decide(
                self.state, self._dstate, raw, starts)
        if self.trainer is not None:
            self.trainer.dispatch(self._dstate)
        return outs, t_dispatch, ver

    def _consume_decide(self, bounds, counts, outs, t_dispatch,
                        version: int) -> List[dict]:
        """Drain the host sinks from the small fused outputs: actions,
        rewards, violation flags and the per-env int32 counts, plus the
        (K, E, F) features only when a LogDB needs them. The fractions
        divide exact integer counts in float64, equal to ``np.mean`` over
        the full (E, S, T) frame bit for bit."""
        k = len(bounds)
        actions_b = outs.actions.cpu().numpy()   # first fetch waits
        batch_latency = time.time() - t_dispatch
        rewards_b = outs.rewards.cpu().numpy()
        obs_c = outs.observed.cpu().numpy()
        fill_c = outs.filled.cpu().numpy()
        anom_c = outs.anomalous.cpu().numpy()
        feat_np = outs.features.cpu().numpy() if self.db is not None \
            else None
        self.predictor.absorb_fused([b[1] for b in bounds],
                                    outs.violated.cpu().numpy())
        denom = float(self.cfg.n_envs * self.cfg.n_streams
                      * self.cfg.n_ticks)
        out = []
        for j, (t_start, t_end) in enumerate(bounds):
            t_host0 = time.time()
            actions, rewards = actions_b[j], rewards_b[j]
            if self.forwarders is not None:
                self.forwarders.dispatch_window(t_end, actions)
            if self.db is not None:
                self.db.append_many(self.env_ids, t_end, feat_np[j], actions,
                                    rewards,
                                    extra={"policy_version": version})
            self.window_index += 1
            latency = batch_latency / k + (time.time() - t_host0)
            self.metrics["tick_latency_s"].append(latency)
            self.metrics["ingest_records"].append(counts[j])
            out.append({
                "window": self.window_index - 1,
                "records": counts[j],
                "latency_s": latency,
                "mean_reward": float(np.mean(rewards)) if rewards.size
                               else 0.0,
                "observed_frac": float(int(obs_c[j].sum()) / denom),
                "filled_frac": float(int(fill_c[j].sum()) / denom),
                "anomalous": int(anom_c[j].sum()),
            })
        return out

    def _dispatch_batch(self, bounds, counts, raw) -> tuple:
        """Launch one assembled batch in this mode; returns the pending
        tuple :meth:`_consume_batch` takes."""
        k = len(bounds)
        if self.fused_decide:
            outs, td, ver = self._dispatch_decide(raw, k)
            return (bounds, counts, outs, td, ver)
        feats, frames, td = self._dispatch_scan(raw, k)
        return (bounds, counts, feats, frames, td)

    def _consume_batch(self, pending) -> List[dict]:
        if self.fused_decide:
            return self._consume_decide(*pending)
        return self._consume_scan(*pending)

    def _advance_clock(self, t_end: float):
        if self.manual_time:
            self._manual_t = t_end + 1e-3
        else:
            while self.now() < t_end:
                time.sleep(0.001)

    # --- state access -----------------------------------------------------------
    def snapshot_state(self):
        """Deep copy of the pipeline state, safe to hold across windows."""
        return _clone(self.state)

    def snapshot_norm(self):
        """Deep copy of just the normalizer stats (``NormState``)."""
        return _clone(self.state.norm)

    def snapshot_decide(self):
        """Deep copy of the fused decision carry (``DecideState``), safe to
        hold across batches: the live carry's ring is written in place by
        every batch."""
        if not self.fused_decide:
            raise ValueError(f"snapshot_decide: mode {self.mode!r} is not a "
                             "fused-decide mode")
        return _clone(self._dstate)

    def replay_size(self) -> int:
        """Live transition count of the replay ring, any mode (fused modes
        share the Predictor's ring)."""
        buf = self.predictor.replay
        return min(int(buf.cursor), buf.capacity)

    def policy_version(self) -> int:
        """The current policy version: 0 until a train step applies, then
        one more per applied step. Swaps land only at batch boundaries, so
        all K windows of a batch share one version, and every replay row
        and LogDB row carries the version that produced its action."""
        return int(self.predictor.policy_version)

    def snapshot_policy(self):
        """A copy of the LIVE policy params: the carry's ``policy`` leaves
        in the fused-decide modes, the Predictor's mirror otherwise."""
        src = (self._dstate.policy if self.fused_decide
               else self.predictor.policy_params)
        return _clone(src)

    def train_stats(self) -> Optional[dict]:
        """The trainer's counters (dispatched/applied/skipped_empty), last
        loss and grad norm and current version; None when training is
        off."""
        return None if self.trainer is None else self.trainer.train_stats()

    def restore_training(self):
        """Crash recovery: restore the newest trainer checkpoint into the
        LIVE serving path — the trainer's state, the Predictor's mirror,
        AND the carry's policy/version leaves (``trainer.restore_latest``
        alone covers the host side; the carry would keep serving the
        construction-time weights). Returns ``(step, params, extra)``, or
        None when there is no checkpoint."""
        if self.trainer is None:
            raise ValueError("restore_training: system built without "
                             "train='online'")
        out = self.trainer.restore_latest()
        if out is None:
            return None
        _, params, _ = out
        self._dstate = self._dstate._replace(
            policy=params, version=torch.tensor(
                self.trainer.version, dtype=torch.int32,
                device=self.device))
        return out

    def export_replay(self, salt: str) -> dict:
        """Anonymized chronological replay export with the host mirror's
        float64 times, any mode (fused modes share the Predictor's ring and
        keep its mirror in step)."""
        return self.predictor.export_replay(self.env_ids, salt)

    def run_windows(self, n: int, pump: bool = True) -> List[dict]:
        if self.mode in _ASYNC_MODES:
            return self._run_windows_async(n, pump)
        if self.mode != "fused":
            out: List[dict] = []
            while len(out) < n:
                k = min(self.scan_k, n - len(out))
                if pump:
                    # advance past the LAST window of the batch so every
                    # window's samples exist before the single drain
                    t_end = self.window_bounds(self.window_index + k - 1)[1]
                    self._advance_clock(t_end)
                    self.pump_receivers()
                out.extend(self.run_windows_scan(k))
            return out
        out = []
        for _ in range(n):
            if pump:
                self._advance_clock(self.window_bounds()[1])
                self.pump_receivers()
            out.append(self.run_window())
        return out

    # --- pipelined (async) operation ------------------------------------------
    def _assemble_for_prefetch(self, bounds, pump: bool):
        """Pump-thread body: exactly the synchronous per-batch sequence
        (clock advance -> receiver poll -> drain/close) at the same window
        boundaries, so the async modes equal their synchronous twins."""
        if pump:
            self._advance_clock(bounds[-1][1])
            self.pump_receivers()
        return self.assemble_windows(bounds)

    def _run_windows_async(self, n: int, pump: bool = True) -> List[dict]:
        """Double-buffered Manager loop: while the Manager runs batch j,
        the pump thread assembles batch j+1. Batch boundaries
        (``min(scan_k, remaining)``) are the synchronous loop's, so the
        drain epochs, and with them the results, are the same."""
        if self._prefetcher is None:
            self._prefetcher = WindowPrefetcher(self._assemble_for_prefetch)
        plans, idx, left = [], self.window_index, n
        while left > 0:
            k = min(self.scan_k, left)
            plans.append([self.window_bounds(idx + j) for j in range(k)])
            idx, left = idx + k, left - k
        for bounds in plans:
            self._prefetcher.submit(bounds, pump=pump)
        out: List[dict] = []
        pending = None
        for _ in plans:
            batch = self._prefetcher.next_batch()
            # consume j-1 BEFORE launching j: the scan consume's decide
            # step queues behind whatever the card holds, and results
            # leave in window order
            if pending is not None:
                out.extend(self._consume_batch(pending))
            pending = self._dispatch_batch(batch.bounds, batch.counts,
                                           batch.raw)
        out.extend(self._consume_batch(pending))
        return out

    def stats(self) -> dict:
        return {
            "queues": self.broker.stats(),
            "receivers": {r.source_id: r.stats for r in self.receivers},
            "translators": {t.source_id: t.stats
                            for t in self.translators.values()},
            "predictor": self.predictor.stats,
        }


def _clone(tree):
    """Deep copy of a tree of tensors (NamedTuples, dicts, None leaves)."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return type(tree)(*(_clone(x) for x in tree))
