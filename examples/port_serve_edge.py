"""The decision loop of ``examples/serve_edge.py`` on the PyTorch/CUDA port.

Simulated MQTT/HTTP/AMQP devices -> Receivers -> Translators -> env queues
-> Accumulator -> the pipeline tick on the card (harmonize, de-spike,
gap-fill, normalize, window features through the locf and window_agg
kernels) -> the rg-LRU registry policy (its state update through the
rglru_scan kernel) -> validated decisions -> reward -> replay ring + LogDB
-> Forwarders. The LM side-car of ``serve_edge.py`` is left out (its port
is driven by ``python -m repro_torch.launch.serve``).

``--mode``:
  * ``fused`` — one pipeline tick and one decision per window;
  * ``scan`` — ``SCAN_K`` windows per pipeline batch, then one
    ``Predictor.on_windows`` over the batch;
  * ``scan_fused_decide`` — the decision step inside the pipeline's K loop
    and one replay-ring write per batch; only the small per-window outputs
    come back to the host;
  * ``scan_async`` / ``scan_fused_decide_async`` — the two batch modes
    with host assembly of batch j+1 on a pump thread while batch j runs.
Every mode gives the same decisions, rewards, DB rows and replay export
(bit for bit). Read the replay through ``system.export_replay`` and
``system.replay_size()``: in the fused modes the system's decision carry
is authoritative.

Run (the card is the default; ``--device cpu`` asks for the CPU):

    PYTHONPATH=src python examples/port_serve_edge.py \\
        [--mode fused|scan|scan_async|scan_fused_decide|\\
         scan_fused_decide_async] [--device cuda|cpu]
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import PipelineConfig
from repro_torch.core.reward import energy_reward_spec
from repro_torch.runtime.db import LogDB
from repro_torch.runtime.forwarder import Forwarder, ForwarderHub
from repro_torch.runtime.policies import PolicyConfig
from repro_torch.runtime.predictor import ActionSpace, Predictor
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec

MODES = ["fused", "scan", "scan_async", "scan_fused_decide",
         "scan_fused_decide_async"]
SCAN_K = 2   # windows per pipeline batch
E = 4        # buildings
WINDOWS = 6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="scan", choices=MODES)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card here (torch.cuda.is_available() is False); "
                 "pass --device cpu to run on the CPU")
    dev = torch.device(args.device)

    sources = [
        SourceSpec("meter", "mqtt", SimulatedDevice("grid_kw", 60.0,
                                                    base=3.0, seed=1)),
        SourceSpec("price", "http", SimulatedDevice(
            "price_eur", 300.0, base=0.2, amplitude=0.05, seed=2)),
        SourceSpec("thermo", "amqp", SimulatedDevice(
            "temp_c", 30.0, base=21.0, amplitude=1.5, seed=3)),
    ]
    use_kernel = dev.type == "cuda"
    pcfg = PipelineConfig(n_envs=E, n_streams=3, n_ticks=8, tick_s=60.0,
                          max_samples=32, gap_strategy="locf",
                          feature_agg="mean", use_kernel=use_kernel)
    pred = Predictor(PolicyConfig("rglru", {"use_kernel": use_kernel}),
                     energy_reward_spec(price_idx=1, grid_idx=0, temp_idx=2),
                     ActionSpace(np.array([-1., -1.]), np.array([1., 1.])),
                     E, pcfg.n_features, replay_capacity=256, device=dev)
    hub = ForwarderHub([Forwarder("hvac", "mqtt", [0]),
                        Forwarder("ev-charger", "amqp", [1])])
    with tempfile.TemporaryDirectory() as db_dir:
        db = LogDB(db_dir, salt="opeva")
        system = PerceptaSystem([f"bldg-{i}" for i in range(E)], sources,
                                pcfg, pred, forwarders=hub, db=db,
                                speedup=4000.0, mode=args.mode,
                                scan_k=SCAN_K, device=dev)
        batch = 1 if args.mode == "fused" else SCAN_K
        print(f"=== Percepta edge decisions on {dev.type}: {WINDOWS} "
              f"windows ({args.mode} mode, {batch} windows a batch) ===")
        t_start = time.time()
        try:
            for _ in range(0, WINDOWS, batch):
                for r in system.run_windows(batch):
                    print(f"window {r['window']}: {r['records']:4d} records"
                          f"  tick {r['latency_s'] * 1e3:6.1f} ms  "
                          f"reward {r['mean_reward']:+.3f}  "
                          f"observed {r['observed_frac']:.0%}  "
                          f"filled {r['filled_frac']:.0%}")
            dt = time.time() - t_start
            sent = {f.dest_id: f.stats["sent"] for f in hub.forwarders}
            print(f"\nforwarded decisions: {sent}")
            dataset = system.export_replay(salt="opeva")
            print(f"DB rows (anonymized): {db.stats['rows']}  "
                  f"replay transitions: {system.replay_size()}  "
                  f"export t=[{dataset['times'][0, 0]:.0f}"
                  f"..{dataset['times'][0, -1]:.0f}]s")
            print(f"wall time {dt:.1f}s for {WINDOWS * 8} stream-minutes x "
                  f"{E} buildings")
        finally:
            system.stop()
            db.close()


if __name__ == "__main__":
    main()
