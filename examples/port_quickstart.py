"""The quickstart of ``examples/quickstart.py`` on the PyTorch/CUDA port:
Percepta's per-tick pipeline on synthetic heterogeneous streams —
harmonization, anomaly handling, gap filling, normalization, reward
computation — with the same streams (the same numpy seed), the same
config and the same printout.

Run (the card is the default; ``--device cpu`` asks for the CPU):

    PYTHONPATH=src python examples/port_quickstart.py [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import PerceptaPipeline, PipelineConfig
from repro_torch.core.frame import make_raw_window
from repro_torch.core.reward import RewardSpec, RewardTerm

E, S, M, T = 4, 3, 48, 16          # envs, streams, raw samples, ticks


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card here (torch.cuda.is_available() is False); "
                 "pass --device cpu to run on the CPU")
    dev = torch.device(args.device)
    cfg = PipelineConfig(n_envs=E, n_streams=S, n_ticks=T, tick_s=60.0,
                         max_samples=M, gap_strategy="locf",
                         anomaly_policy="clip")
    pipe = PerceptaPipeline(cfg, mode="fused", device=dev)
    state = pipe.init_state()

    rng = np.random.RandomState(0)
    reward = RewardSpec((
        RewardTerm("linear", weight=-1.0, feature=0),        # cost of stream0
        RewardTerm("band_penalty", weight=2.0, feature=2, target=21.0,
                   band=1.0),
    ))

    for window in range(5):
        t0 = window * T * 60.0
        # three sources at different rates: 30 s / 120 s / 600 s
        rates = [30.0, 120.0, 600.0]
        vals = np.zeros((E, S, M), np.float32)
        ts = np.zeros((E, S, M), np.float32)
        ok = np.zeros((E, S, M), bool)
        for s, r in enumerate(rates):
            n = min(int(T * 60 / r), M)
            ts[:, s, :n] = t0 + (np.arange(n) + 1) * r \
                + rng.uniform(0, 1, (E, n))
            base = [3.0, 0.2, 21.0][s]
            vals[:, s, :n] = base + rng.normal(0, 0.1 * base, (E, n))
            ok[:, s, :n] = rng.rand(E, n) > 0.15          # 15% loss
        vals[0, 0, 3] += 500.0                            # inject a spike
        raw = make_raw_window(vals, ts, ok, device=dev)

        state, feats, frame = pipe.run_tick(
            state, raw, torch.full((E,), t0, dtype=torch.float32,
                                   device=dev))
        total, per_term = reward.compute(
            feats.raw, torch.zeros((E, 1), dtype=torch.float32, device=dev))
        observed = frame.observed.float().mean().item()
        filled = frame.filled.float().mean().item()
        print(f"window {window}: observed {observed:.0%} "
              f"filled {filled:.0%} "
              f"spikes {int(frame.anomalous.sum().item())} "
              f"reward {total.mean().item():+.2f}")

    print("feature vector (env 0):", feats.features[0].cpu().numpy().round(2))
    print("raw engineering units  :", feats.raw[0].cpu().numpy().round(2))


if __name__ == "__main__":
    main()
