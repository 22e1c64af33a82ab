"""The cloud mode of ``examples/multi_env_cloud.py`` on the PyTorch/CUDA
port: one Percepta instance serving many isolated environments at once,
swept over the env count (1, 8, 64, 256) with the latency of a window per
env. Environments are rows of one tick, so the latency grows far less
than the env count.

Run (the card is the default; ``--device cpu`` asks for the CPU):

    PYTHONPATH=src python examples/port_multi_env_cloud.py \\
        [--device cuda|cpu] [--envs 1,8,64,256]

The latencies are host-clock times of ``run_windows`` on the device
named in the header line, not a benchmark.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import PipelineConfig
from repro_torch.core.reward import energy_reward_spec
from repro_torch.runtime.predictor import (ActionSpace, Predictor,
                                           linear_policy)
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--envs", default="1,8,64,256",
                    help="comma-separated env counts")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card here (torch.cuda.is_available() is False); "
                 "pass --device cpu to run on the CPU")
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"=== Percepta cloud mode: environment-count scaling ({name}) ===")
    print(f"{'envs':>6s} {'tick ms':>9s} {'us/env':>8s} {'env-ticks/s':>12s}")

    for E in (int(e) for e in args.envs.split(",")):
        sources = [
            SourceSpec("meter", "mqtt", SimulatedDevice(
                "grid_kw", 60.0, base=3.0, seed=1)),
            SourceSpec("price", "http", SimulatedDevice(
                "price", 300.0, base=0.2, amplitude=0.05, seed=2)),
            SourceSpec("thermo", "amqp", SimulatedDevice(
                "temp_c", 30.0, base=21.0, seed=3)),
        ]
        pcfg = PipelineConfig(n_envs=E, n_streams=3, n_ticks=8, tick_s=60.0,
                              max_samples=16)
        pred = Predictor(linear_policy(3, 2, device=dev),
                         energy_reward_spec(price_idx=1, grid_idx=0,
                                            temp_idx=2),
                         ActionSpace(np.array([-1., -1.]),
                                     np.array([1., 1.])),
                         E, pcfg.n_features, replay_capacity=8, device=dev)
        system = PerceptaSystem([f"b{i}" for i in range(E)], sources, pcfg,
                                pred, speedup=50000.0, device=dev)
        system.run_windows(1)          # warm-up: first launches, allocator
        res = system.run_windows(2)
        system.stop()
        lat = np.mean([r["latency_s"] for r in res])
        print(f"{E:6d} {lat*1e3:9.2f} {lat/E*1e6:8.1f} {E/lat:12.0f}")

    print("\nisolation: each env keeps its own queue/accumulator/state row;"
          "\nthe batched tick scales sub-linearly in env count (rows of one "
          "tick).")


if __name__ == "__main__":
    main()
