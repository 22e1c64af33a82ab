"""PerceptaSystem — port of ``repro.runtime.system``: the ``fused``,
``modular``, ``scan``, ``scan_fused_decide``, ``scan_async`` and
``scan_fused_decide_async`` Manager loops and their four ``*_sharded``
twins.

All environments are rows of the batched device pipeline; isolation is by
construction (per-env queues, per-env state rows, per-env model slots).
Time is virtual (``speedup``, or ``manual_time`` for deterministic runs).

``mode="fused"``: :meth:`run_window` closes each env's window, runs one
pipeline tick and one ``Predictor.on_tick``, forwards the decisions and
logs them; ``mode="modular"`` runs the same loop with the tick stage by
stage, the host waiting for the card after each stage (the paper's
architecture as drawn; bit-identical to ``fused``). ``mode="scan"``:
queues are drained once per batch, each env's Accumulator closes K
consecutive windows straight into (K, E, S, M) staging buffers, one
``PerceptaPipeline.run_many`` processes the batch on the device, and one
``Predictor.on_windows`` consumes it (``batched_consume=False``: one
``Predictor.on_tick`` a window, the reference path the batched one
equals); host sinks see one result row per window, in window order,
bit-identical to ``fused``.

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
ring has one rule: the Predictor's ``replay`` IS the ring the carry
writes, in place, by each batch (a tuple of shard rings in the sharded
fused modes, below), and ``Predictor.absorb_fused`` keeps its float64 time
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

``elastic=True`` (scan modes only) makes the env axis a slot pool of
``env_slots`` rows. An ``active`` (E,) bool device mask (in the scan
modes an input of every ``run_many``, in the fused-decide modes the
``DecideState.active``/``prev_ok`` carry leaves) marks the live slots,
and :meth:`attach_env` / :meth:`detach_env` change it between window
batches only (in the async modes the prefetcher's membership tag checks
that). A membership change rewrites the mask tensors in place; no shape
changes. Inactive slots get all-invalid windows (their state updates are
no-ops) and zeros on every output, and no host sink sees them (stats,
LogDB, forwarders, replay export); live rows equal a dense system's over
the same envs bit for bit. A full pool grows by :meth:`resize`
(``distribution.elastic``): every env-leading tree is padded from a fresh
init template, the pipeline is rebuilt at the new width and the staging
pool dropped; surviving rows resume bit for bit.

``mode="scan_sharded"`` / ``"scan_async_sharded"`` run the scan engine
with the env rows split over an ``EnvMesh`` (``distribution.sharding``;
default: ``env_mesh`` over ``sharding.visible_devices(device)``, the CUDA
cards): the pipeline state is a tuple of per-shard states, and each batch
is split, run shard by shard (every shard launched before anything is
read) and gathered on the mesh's first device, where the Predictor
consumes it unsharded. ``"scan_fused_decide_sharded"`` /
``"scan_fused_decide_async_sharded"`` split the decide carry too
(``sharding.decide_specs``: prev rows, model carry, masks and ring rows on
their shard, the policy params and the scalars replicated), so the ring
becomes one ring per shard. The Predictor's ``replay`` becomes the tuple
of shard rings (its whole-width ring is dropped), and
:meth:`export_replay`, :meth:`replay_size`, :meth:`snapshot_decide` and
the trainer read it in the unsharded row order. Results equal the
unsharded twin's bit for bit. One mesh device
degenerates to one shard; a mesh may name one card N times (logical
shards), which is how the shard logic is tested on one device. Online
training runs its step on the mesh's first device over the minibatch
gathered from the shard rings, and a new policy is copied to every shard
at the batch boundary; an elastic pool's :meth:`resize` re-chooses the
mesh (``elastic.next_pool_size`` rounds the pool to the device count) and
places the grown trees on it.

The fused-decide modes will not start without a
``analysis.certify.PolicyCertificate`` (``contract_check=True``, the
default): a registry policy brings one from its build; any other model is
certified here at the true (E, F, A). The env and carry rules bind only in
the sharded fused modes, where the decision math runs per shard, and are
probed there at the shard widths the mesh can give, again at the new
mesh's width on every :meth:`resize`; a policy whose rows depend on each
other or on the row count is refused with a ``ContractViolation`` naming
the reference's rule id.

``scan_k="auto"`` runs ``core.autotune.tune_scan_params`` at construction
(``autotune`` holds its keyword arguments): a measured grid over windows
per batch x mesh split (splits only in the sharded modes) picks the
windows/s argmax of the engine that will run; the result is kept on
``self.tuned`` and the mesh is built over its ``mesh_devices``.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import PerceptaPipeline, PipelineConfig
from repro_torch.core import replay as rp
from repro_torch.core.frame import make_raw_window
from repro_torch.core.pipeline import init_state
from repro_torch.device import resolve_device
from repro_torch.distribution import elastic as el
from repro_torch.distribution import sharding as sh
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
    "modular": "modular",
    "scan": "scan",
    "scan_sharded": "scan_sharded",
    "scan_async": "scan",
    "scan_async_sharded": "scan_sharded",
    "scan_fused_decide": "scan_fused_decide",
    "scan_fused_decide_sharded": "scan_fused_decide_sharded",
    "scan_fused_decide_async": "scan_fused_decide",
    "scan_fused_decide_async_sharded": "scan_fused_decide_sharded",
}
_FUSED_DECIDE_MODES = ("scan_fused_decide", "scan_fused_decide_sharded",
                       "scan_fused_decide_async",
                       "scan_fused_decide_async_sharded")
_SCAN_MODES = ("scan", "scan_sharded", "scan_async",
               "scan_async_sharded") + _FUSED_DECIDE_MODES
_ASYNC_MODES = ("scan_async", "scan_async_sharded",
                "scan_fused_decide_async", "scan_fused_decide_async_sharded")
# pipeline modes whose batches run over the env mesh's shards
_SHARDED_PIPE_MODES = ("scan_sharded", "scan_fused_decide_sharded")


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
                 autotune: Optional[dict] = None,
                 batched_consume: bool = True,
                 contract_check: bool = True,
                 train: Optional[str] = None,
                 train_cfg: Optional[dict] = None, policy=None,
                 env_slots: Optional[int] = None, elastic: bool = False,
                 ingest_workers: int = 1, ingest_fastpath: bool = True,
                 device=None):
        if mode not in _PIPELINE_MODE:
            raise ValueError(f"unknown mode {mode!r}")
        if elastic and mode not in _SCAN_MODES:
            raise ValueError(
                "elastic=True needs a scan engine (the active mask rides "
                f"the batch); mode {mode!r} runs one window at a time")
        if train is not None and train != "online":
            raise ValueError(f"unknown train mode {train!r} "
                             "(expected None or 'online')")
        if train is not None and mode not in _FUSED_DECIDE_MODES:
            raise ValueError(
                "train='online' rides the fused decide carry: use a "
                f"scan_fused_decide* mode, not {mode!r}")
        self.device = resolve_device(device)
        if predictor.device != self.device:
            raise ValueError(f"predictor lives on {predictor.device}, the "
                             f"system on {self.device}")
        # elastic: the env axis is a slot pool of env_slots rows, of which
        # the masked subset is live (module docstring)
        self.elastic = bool(elastic)
        if self.elastic:
            slots = int(env_slots) if env_slots is not None \
                else pipeline_cfg.n_envs
            if len(env_ids) > slots:
                raise ValueError(f"elastic: {len(env_ids)} envs do not fit "
                                 f"{slots} slots")
            if pipeline_cfg.n_envs != slots:
                raise ValueError("elastic: pipeline_cfg.n_envs must equal "
                                 f"env_slots ({pipeline_cfg.n_envs} != "
                                 f"{slots})")
            if predictor.n_envs != slots:
                raise ValueError("elastic: build the Predictor at env_slots "
                                 f"rows ({predictor.n_envs} != {slots})")
            self.env_slots: Optional[int] = slots
            self._slot_env: List[Optional[str]] = \
                list(env_ids) + [None] * (slots - len(env_ids))
            self._free_slots: List[int] = list(range(len(env_ids), slots))
            # host mirrors of the device masks
            self._active = np.zeros(slots, bool)
            self._active[:len(env_ids)] = True
            self._prev_ok = np.zeros(slots, bool)
        else:
            if env_slots is not None and env_slots != len(env_ids):
                raise ValueError("env_slots beyond len(env_ids) requires "
                                 "elastic=True")
            if pipeline_cfg.n_envs != len(env_ids):
                raise ValueError("pipeline_cfg.n_envs must equal "
                                 "len(env_ids)")
            self.env_slots = None
        self._membership_epoch = 0
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
        self.fused_decide = mode in _FUSED_DECIDE_MODES
        self._sharded = pipe_mode in _SHARDED_PIPE_MODES
        if policy is not None:
            predictor.set_model(policy)
        # fused-decide: the Predictor hands its decision state over as the
        # device carry and only keeps host bookkeeping (absorb_fused)
        decide = predictor.make_decide_fn() if self.fused_decide else None
        self._decide = decide
        self._dstate = predictor.decide_state() if self.fused_decide \
            else None
        if self.elastic:
            # the masks live on the card: in the fused carry, or beside the
            # state for the scan modes' run_many and on_windows
            act, ok = self._device_masks()
            if self.fused_decide:
                self._dstate = self._dstate._replace(active=act, prev_ok=ok)
            else:
                self._active_dev, self._prev_ok_dev = act, ok
        visible = sh.visible_devices(self.device)
        # the policy gate, before anything is tuned or placed
        self.contract_check = bool(contract_check)
        self.policy_certificate = None
        if self.contract_check and self.fused_decide:
            E = pipeline_cfg.n_envs
            if not self._sharded:
                counts = [1]
            elif scan_k == "auto":
                # every split the tuner may choose
                from repro_torch.core.autotune import candidate_device_counts
                counts = (autotune or {}).get("device_counts") or \
                    candidate_device_counts(E, len(visible))
            else:
                counts = [sh.env_mesh(E, visible).size]
            self.policy_certificate = self._certify(predictor, E, counts)
        # scan_k="auto": a measured grid over K x mesh split
        self.tuned = None
        mesh = None
        if scan_k == "auto":
            from repro_torch.core.autotune import tune_scan_params
            kw = dict(autotune or {})
            if not self._sharded:
                # mesh splits only apply to the sharded engines
                kw.setdefault("device_counts", [1])
            if self.fused_decide:
                kw.setdefault("decide", decide)
                kw.setdefault("decide_state", self._dstate)
            kw.setdefault("device", self.device)
            self.tuned = tune_scan_params(pipeline_cfg, **kw)
            scan_k = self.tuned.scan_k
            if self._sharded:
                # honour the measured split, one device included
                mesh = sh.env_mesh(
                    pipeline_cfg.n_envs,
                    visible[:max(1, self.tuned.mesh_devices)])
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
        # scan-mode consume: one Predictor.on_windows a batch (default);
        # False keeps the per-window on_tick loop, the reference path the
        # batched one equals bit for bit
        self.batched_consume = bool(batched_consume)
        self.pipeline = PerceptaPipeline(pipeline_cfg, mode=pipe_mode,
                                         device=self.device, decide=decide,
                                         elastic=self.elastic, mesh=mesh,
                                         decide_state=self._dstate)
        self.mesh = self.pipeline.mesh
        # sharded modes: per-shard states and carries from here on
        self.state = self.pipeline.init_state()
        if self.fused_decide:
            self._dstate = self.pipeline.place_decide(self._dstate)
        self._prefetcher: Optional[WindowPrefetcher] = None
        self.predictor = predictor
        if self.fused_decide:
            self._adopt_ring()
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

    def _certify(self, predictor, E: int, counts):
        """The policy certificate the fused-decide modes demand: the
        model's own (a registry build's) outside the sharded modes, else
        one probed here at the true (E, F, A); in the sharded modes the
        env and carry rules bind, at the shard width E/n of every mesh
        size n in ``counts``."""
        from repro_torch.analysis import certify
        cert = getattr(predictor.model, "certificate", None)
        if cert is not None and not self._sharded:
            return cert
        widths = tuple(sorted({E // n for n in counts if n > 1
                               and E % n == 0}))
        found = certify.certify_policy(
            predictor.model,
            ((E, predictor.n_features, predictor.action_space.n),),
            name=getattr(predictor.model, "name", None),
            rules=certify.Rules(env=self._sharded, carry=self._sharded),
            shard_widths=widths, device=self.device)
        if cert is None:
            predictor.model.certificate = found
        return found

    # --- the shards of a sharded tree (one shard when unsharded) -------------
    def _shards(self, tree) -> tuple:
        return tuple(tree) if self._sharded else (tree,)

    def _unshard(self, shards):
        return tuple(shards) if self._sharded else shards[0]

    def _owner(self, slot: int) -> tuple:
        """``(shard, row within it)`` of a global env row."""
        if not self._sharded:
            return 0, slot
        return self.mesh.owner(slot, self.cfg.n_envs)

    def _shard_of(self, tree, j: int):
        """Shard ``j``'s rows of a whole (E, ...)-leading tree (views)."""
        if not self._sharded:
            return tree
        return sh.shard_of(tree, 0, self.mesh, j)

    def _adopt_ring(self) -> None:
        """Point the Predictor at the ring the carry writes (the ring's
        one rule, module docstring): the same ring unsharded, the tuple of
        shard rings sharded, which drops the whole-width ring."""
        self.predictor.replay = self._unshard(
            [d.replay for d in self._shards(self._dstate)])

    def _reset_rows(self, tree, template, slot: int):
        """``elastic.reset_env_rows`` of one global row, in the shard that
        holds it; ``template`` is a whole (unsharded) tree."""
        j, r = self._owner(slot)
        shards = list(self._shards(tree))
        shards[j] = el.reset_env_rows(shards[j], self._shard_of(template, j),
                                      [r])
        return self._unshard(shards)

    def _set_policy(self, params, version) -> None:
        """Put new policy params and version into every shard's carry (a
        tensor is never written in place, so a shard on the params' own
        device shares them)."""
        from repro_torch.train import tree
        self._dstate = self._unshard([
            d._replace(policy=tree.map_(
                lambda x, dev=d.tick.device: x.to(dev), params),
                version=version.to(d.tick.device))
            for d in self._shards(self._dstate)])

    def _train_view(self):
        """The carry the trainer reads: shard 0's, with the shard rings as
        one sharded ring (``replay.gather`` reads it in row order)."""
        if not self._sharded:
            return self._dstate
        return self._dstate[0]._replace(replay=self.predictor.replay)

    def _land_step(self, flush: bool = False) -> None:
        """Adopt the trainer's launched step into the carry (every
        shard's)."""
        view = self._train_view()
        land = self.trainer.flush_pending if flush \
            else self.trainer.apply_pending
        new = land(view)
        if not self._sharded:
            self._dstate = new
        elif new is not view:
            self._set_policy(new.policy, new.version)

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

    def _live_slots(self) -> List[tuple]:
        """``[(slot_row, env_id), ...]`` of the live envs in slot order:
        ``env_ids`` densely, or the pool's occupied active slots, so host
        loops (ingest, sinks, stats) never touch a dead row."""
        if not self.elastic:
            return list(enumerate(self.env_ids))
        return [(i, e) for i, e in enumerate(self._slot_env)
                if e is not None and self._active[i]]

    def _live_rows(self):
        """``(rows, ids)``: the live slot rows as an int64 index (None for
        a dense system, whose sinks take every row) and their env ids."""
        if not self.elastic:
            return None, self.env_ids
        live = self._live_slots()
        return np.asarray([i for i, _ in live], np.int64), \
            [e for _, e in live]

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
        # free and inactive slots keep their all-invalid zero rows
        live = self._live_slots()
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
                self.state, raw, starts,
                self._active_dev if self.elastic else None)
        return feats, frames, t_dispatch

    def _consume_scan(self, bounds, counts, feats, frames,
                      t_dispatch) -> List[dict]:
        """Run the batch's host side (Predictor, Forwarders, DB, metrics)
        in window order: one ``Predictor.on_windows`` over the stacked
        features (or one ``on_tick`` a window, ``batched_consume=False``),
        then per-window numpy slices for the sinks. Elastic: the Predictor
        takes the whole pool and the masks, the sinks and stats only the
        live rows."""
        k = len(bounds)
        rows, ids = self._live_rows()
        masks = ({"active": self._active_dev, "prev_ok": self._prev_ok_dev}
                 if self.elastic else {})
        if self.batched_consume:
            actions_b, rewards_b, _ = self.predictor.on_windows(
                feats.features, [b[1] for b in bounds], raw=feats.raw,
                **masks)
            self._advance_prev_ok()
            batch_latency = time.time() - t_dispatch
        # one batch-wide host transfer per leaf; the per-window loop
        # slices numpy
        feat_np = feats.features.cpu().numpy()
        if not self.batched_consume:
            batch_latency = time.time() - t_dispatch
        obs_np = frames.observed.cpu().numpy()
        fill_np = frames.filled.cpu().numpy()
        anom_np = frames.anomalous.cpu().numpy()
        out = []
        for j, (t_start, t_end) in enumerate(bounds):
            t_host0 = time.time()
            if self.batched_consume:
                actions, rewards = actions_b[j], rewards_b[j]
            else:
                # the per-window step stays inside the timed region, so
                # latency_s counts the Predictor's time
                actions, rewards, _ = self.predictor.on_tick(
                    feats.features[j], t_end, raw=feats.raw[j], **masks)
                self._advance_prev_ok()
            feat_j, obs_j, fill_j, anom_j = (feat_np[j], obs_np[j],
                                             fill_np[j], anom_np[j])
            if rows is not None:
                # sinks and stats never see (or average over) a dead
                # slot's zeros
                actions, rewards, feat_j, obs_j, fill_j, anom_j = (
                    x[rows] for x in (actions, rewards, feat_j, obs_j,
                                      fill_j, anom_j))
            if self.forwarders is not None:
                self.forwarders.dispatch_window(t_end, actions)
            if self.db is not None:
                self.db.append_many(ids, t_end, feat_j, actions, rewards,
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
                "observed_frac": float(obs_j.mean()) if obs_j.size else 0.0,
                "filled_frac": float(fill_j.mean()) if fill_j.size else 0.0,
                "anomalous": int(anom_j.sum()),
            })
        return out

    def _advance_prev_ok(self) -> None:
        """After a consumed window (scan modes): every active slot now has
        a predecessor, on the host mirror and on the card (in place)."""
        if self.elastic:
            self._prev_ok |= self._active
            self._prev_ok_dev |= self._active_dev

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
            self._land_step()
        ver = int(self.predictor.policy_version)
        t_dispatch = time.time()
        starts = torch.zeros((k, self.cfg.n_envs), dtype=torch.float32,
                             device=self.device)
        with torch.no_grad():
            self.state, self._dstate, outs = self.pipeline.run_many_decide(
                self.state, self._dstate, raw, starts)
        if self.elastic:
            # host mirror of the carry's prev_ok = prev_ok | active
            self._prev_ok |= self._active
        if self.trainer is not None:
            self.trainer.dispatch(self._train_view())
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
        # elastic: the counts of inactive rows are zeros, so whole-row sums
        # are the live rows'; the fractions divide by the live row count
        rows, ids = self._live_rows()
        n_rows = self.cfg.n_envs if rows is None else max(len(rows), 1)
        denom = float(n_rows * self.cfg.n_streams * self.cfg.n_ticks)
        out = []
        for j, (t_start, t_end) in enumerate(bounds):
            t_host0 = time.time()
            actions, rewards = actions_b[j], rewards_b[j]
            feat_j = feat_np[j] if feat_np is not None else None
            if rows is not None:
                actions, rewards = actions[rows], rewards[rows]
                if feat_j is not None:
                    feat_j = feat_j[rows]
            if self.forwarders is not None:
                self.forwarders.dispatch_window(t_end, actions)
            if self.db is not None:
                self.db.append_many(ids, t_end, feat_j, actions, rewards,
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

    # --- elastic membership (attach / detach / resize) --------------------------
    def _assert_membership_boundary(self):
        if not self.elastic:
            raise ValueError("attach/detach/resize require elastic=True")
        if self._prefetcher is not None and self._prefetcher.in_flight():
            raise RuntimeError(
                "membership changes only at batch boundaries: a window "
                "batch plan is still in flight (finish run_windows first)")

    def _refresh_env_ids(self):
        self.env_ids = [e for _, e in self._live_slots()]

    def _export_env_ids(self) -> List[str]:
        """Slot-table env ids at the full pool width (the replay export
        keys rows by slot; a free slot gets a placeholder that matches no
        valid row)."""
        if not self.elastic:
            return self.env_ids
        return [e if e is not None else f"__slot{i}__"
                for i, e in enumerate(self._slot_env)]

    def _device_masks(self):
        """Device copies of the host mirrors (never views of them: the
        mirrors change in place on the host)."""
        return tuple(torch.tensor(m, dtype=torch.bool, device=self.device)
                     for m in (self._active, self._prev_ok))

    def _push_masks(self) -> None:
        """Write the host mirrors into the device masks, in place (each
        shard's rows into its carry's masks in the sharded fused modes)."""
        if not self.fused_decide:
            self._active_dev.copy_(torch.from_numpy(self._active))
            self._prev_ok_dev.copy_(torch.from_numpy(self._prev_ok))
            return
        E = self.cfg.n_envs
        for j, d in enumerate(self._shards(self._dstate)):
            rows = self.mesh.rows(j, E) if self._sharded else slice(None)
            d.active.copy_(torch.from_numpy(self._active[rows]))
            d.prev_ok.copy_(torch.from_numpy(self._prev_ok[rows]))

    def _scrub_slot(self, slot: int) -> None:
        """Clear a recycled slot's decision rows (prev rows, model carry,
        the ring's ``valid``) and push the masks to the card."""
        if self.fused_decide:
            j, r = self._owner(slot)
            shards = list(self._shards(self._dstate))
            d = shards[j]
            zero = lambda x: el.reset_env_rows(x, torch.zeros_like(x), [r])
            carry = d.carry
            if carry is not None:
                carry = el.reset_env_rows(carry, self._shard_of(
                    self.predictor.model.init_carry(self.cfg.n_envs), j),
                    [r])
            # the ring (the Predictor's too) is written in place by every
            # batch; its valid column is scrubbed the same way
            d.replay.valid[r] = False
            shards[j] = d._replace(prev_obs=zero(d.prev_obs),
                                   prev_actions=zero(d.prev_actions),
                                   carry=carry)
            self._dstate = self._unshard(shards)
        else:
            self.predictor.clear_env_rows([slot])
        self._push_masks()

    def attach_env(self, env_id: str) -> int:
        """Join a new env into the lowest free slot between window batches.

        Only the mask's values change. The slot's pipeline-state rows are
        reset from a fresh init template (its sentinels, ``prev_ts`` and
        the norm min/max, are not zeros), its decision rows are scrubbed,
        and its receiver subscriptions start a fresh poll horizon now. A
        full pool grows first (:meth:`resize`). Returns the slot row."""
        self._assert_membership_boundary()
        if env_id in self.accumulators:
            raise ValueError(f"env {env_id!r} is already attached")
        if not self._free_slots:
            self.resize()
        slot = self._free_slots.pop(0)
        self._slot_env[slot] = env_id
        self._active[slot] = True
        self._prev_ok[slot] = False
        self._register_env(env_id)
        self.state = self._reset_rows(self.state,
                                      init_state(self.cfg, self.device), slot)
        self._scrub_slot(slot)
        self._refresh_env_ids()
        self._membership_epoch += 1
        return slot

    def detach_env(self, env_id: str) -> int:
        """Remove a live env and free its slot. Its receiver subscriptions,
        queue and Accumulator go (pending records are dropped), and its
        decision rows are scrubbed, so a later tenant never sees the
        departed env's data. Returns the freed slot row."""
        self._assert_membership_boundary()
        if env_id not in self.accumulators:
            raise ValueError(f"env {env_id!r} is not attached")
        slot = self._slot_env.index(env_id)
        for r in self.receivers:
            r.unsubscribe(env_id)
        self.broker.remove(env_id)
        self.accumulators.pop(env_id).reset()
        self._slot_env[slot] = None
        self._active[slot] = False
        self._prev_ok[slot] = False
        bisect.insort(self._free_slots, slot)
        self._scrub_slot(slot)
        self._refresh_env_ids()
        self._membership_epoch += 1
        return slot

    def resize(self, new_slots: Optional[int] = None) -> int:
        """Grow the slot pool: the one change of shape.

        Lands a pending train step in the carry first, pads every
        env-leading tree from a fresh init template at the new width
        (surviving rows copied bit for bit), rebuilds the pipeline there
        and drops the staging pool, whose buffers are keyed by the width.
        The sharded modes gather their shards first, re-choose the mesh
        at the new width (the pool rounded up to a multiple of the device
        count) and place the grown trees on it; a sharded fused system
        certifies its policy again at the new mesh's shard width first, and
        a refusal leaves the system as it was. Returns the new slot
        count."""
        self._assert_membership_boundary()
        old = self.env_slots
        visible = sh.visible_devices(self.device)
        n_dev = len(visible) if self._sharded else 1
        if new_slots is None:
            new_slots = el.next_pool_size(old + 1, old, n_dev)
        if new_slots <= old:
            raise ValueError(f"resize: {new_slots} slots, the pool has {old}")
        mesh = sh.env_mesh(new_slots, visible) if self._sharded else None
        if self.contract_check and self.fused_decide and self._sharded:
            # the probes read the row count: a new width is a new check
            self.policy_certificate = self._certify(
                self.predictor, new_slots, [mesh.size])
        if self.trainer is not None:
            # a step launched against the old-width carry lands first
            self._land_step(flush=True)
        # from here on whole trees: the shards come back together
        self.state = self.pipeline.gather_state(self.state)
        if self.fused_decide:
            self._dstate = self.pipeline.gather_decide(self._dstate)
        pad = new_slots - old
        self._active = np.concatenate([self._active, np.zeros(pad, bool)])
        self._prev_ok = np.concatenate([self._prev_ok, np.zeros(pad, bool)])
        self._slot_env.extend([None] * pad)
        self._free_slots.extend(range(old, new_slots))
        if self.fused_decide:
            # the carry is authoritative for the prev rows, the model carry
            # and the ring (gathered whole); grow_envs pads the
            # Predictor's, so hand them over
            d = self._dstate
            self.predictor.replay = d.replay
            self.predictor._prev["obs"] = d.prev_obs
            self.predictor._prev["actions"] = d.prev_actions
            self.predictor._model_carry = d.carry
        self.predictor.grow_envs(new_slots)
        act, ok = self._device_masks()
        if self.fused_decide:
            # the ring grows in the Predictor
            strip = dict(replay=None, active=None, prev_ok=None)
            d = el.grow_env_tree(self._dstate._replace(**strip),
                                 self.predictor.decide_state()._replace(
                                     **strip), old)
            self._dstate = d._replace(replay=self.predictor.replay,
                                      active=act, prev_ok=ok)
        else:
            self._active_dev, self._prev_ok_dev = act, ok
        self.cfg = dataclasses.replace(self.cfg, n_envs=new_slots)
        self.pipeline = PerceptaPipeline(
            self.cfg, mode=self.pipeline.mode, device=self.device,
            decide=self._decide, elastic=True, mesh=mesh,
            decide_state=self._dstate)
        self.mesh = self.pipeline.mesh
        self.state = self.pipeline.place_state(el.grow_env_tree(
            self.state, init_state(self.cfg, self.device), old))
        if self.fused_decide:
            self._dstate = self.pipeline.place_decide(self._dstate)
            self._adopt_ring()
        self.env_slots = new_slots
        self._stage_pool.clear()
        self._membership_epoch += 1
        return new_slots

    # --- state access -----------------------------------------------------------
    def snapshot_state(self):
        """Deep copy of the pipeline state, safe to hold across windows
        (the whole state, its shards gathered, in the sharded modes)."""
        return _clone(self.pipeline.gather_state(self.state))

    def snapshot_norm(self):
        """Deep copy of just the normalizer stats (``NormState``)."""
        return _clone(self.pipeline.gather_state(self.state).norm)

    def snapshot_decide(self):
        """Deep copy of the fused decision carry (``DecideState``), safe to
        hold across batches: the live carry's ring is written in place by
        every batch. Sharded: the shards gathered, rows in order."""
        if not self.fused_decide:
            raise ValueError(f"snapshot_decide: mode {self.mode!r} is not a "
                             "fused-decide mode")
        return _clone(self.pipeline.gather_decide(self._dstate))

    def replay_size(self) -> int:
        """Live transition count of the replay ring, any mode (every
        shard's ring has the same cursor)."""
        buf = rp.shard_rings(self.predictor.replay)[0]
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
        src = (self._shards(self._dstate)[0].policy if self.fused_decide
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
        self._set_policy(params, torch.tensor(
            self.trainer.version, dtype=torch.int32, device=self.device))
        return out

    def export_replay(self, salt: str) -> dict:
        """Anonymized chronological replay export with the host mirror's
        float64 times, any mode (fused modes share the Predictor's ring and
        keep its mirror in step). Elastic: every slot's rows, free slots
        under placeholder ids and all-invalid."""
        return self.predictor.export_replay(self._export_env_ids(), salt)

    def run_windows(self, n: int, pump: bool = True) -> List[dict]:
        if self.mode in _ASYNC_MODES:
            return self._run_windows_async(n, pump)
        if self.mode in _SCAN_MODES:
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
            self._prefetcher.submit(bounds, pump=pump,
                                    membership=self._membership_epoch)
        out: List[dict] = []
        pending = None
        for _ in plans:
            batch = self._prefetcher.next_batch()
            if batch.membership != self._membership_epoch:
                raise RuntimeError(
                    "membership changed while a batch plan was in flight "
                    f"(plan built under epoch {batch.membership}, now "
                    f"{self._membership_epoch}); attach/detach/resize only "
                    "between run_windows calls")
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
