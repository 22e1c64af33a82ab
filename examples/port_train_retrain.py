"""Online retraining on the PyTorch/CUDA port: the policy learns on the
device while the fused decide path serves, with versioned hot-swaps and
crash-recovery checkpoints. The twin of ``examples/train_retrain.py``.

``train="online"`` attaches ``runtime.trainer.OnlineTrainer``: one step
per K-window batch samples a minibatch from the replay ring in place, takes
the TD/regression gradient and runs the repo's AdamW, launched right
behind the batch's decide launch on the same stream. The new weights
replace the decide carry's at the next batch boundary (never inside a
batch), and every decision row is stamped with the ``policy_version`` that
produced it. A simulated crash halfway through restores the newest
checkpoint into a fresh system, which goes on serving and training.

Run (the card is the default; ``--device cpu`` asks for the CPU):

    PYTHONPATH=src python examples/port_train_retrain.py \\
        [--windows 30] [--scan-k 5] [--policy linear|mlp] [--device cuda|cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core import PipelineConfig
from repro_torch.core.reward import energy_reward_spec
from repro_torch.runtime.policies import PolicyConfig
from repro_torch.runtime.predictor import ActionSpace, Predictor
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec


def build(args, dev, train_cfg):
    srcs = [SourceSpec("meter", "mqtt",
                       SimulatedDevice("grid_kw", 60.0, base=3.0, seed=1)),
            SourceSpec("price", "http",
                       SimulatedDevice("price_eur", 300.0, base=0.2,
                                       amplitude=0.05, seed=2))]
    cfg = PipelineConfig(n_envs=2, n_streams=2, n_ticks=8, tick_s=60.0,
                         max_samples=32, gap_strategy="locf",
                         feature_agg="mean", use_kernel=dev.type == "cuda")
    pred = Predictor(PolicyConfig(args.policy),
                     energy_reward_spec(price_idx=1, grid_idx=0, temp_idx=0),
                     ActionSpace(np.array([-1., -1.]), np.array([1., 1.])),
                     2, cfg.n_features, replay_capacity=64, device=dev)
    return PerceptaSystem(["bldg-0", "bldg-1"], srcs, cfg, pred,
                          speedup=5000.0, manual_time=True,
                          mode="scan_fused_decide", scan_k=args.scan_k,
                          train="online", train_cfg=train_cfg, device=dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=30)
    ap.add_argument("--scan-k", type=int, default=5)
    ap.add_argument("--policy", default="linear", choices=["linear", "mlp"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card here (torch.cuda.is_available() is False); "
                 "pass --device cpu to run on the CPU")
    # the pre-crash half must cover >= 2 batches so that at least one step
    # is APPLIED (and so checkpointed) before the simulated crash
    if args.windows < 4 * args.scan_k:
        ap.error("--windows must be >= 4 * --scan-k")
    dev = torch.device(args.device)

    with tempfile.TemporaryDirectory() as ckdir:
        tcfg = {"batch_size": 64, "checkpoint_dir": ckdir,
                "checkpoint_every": 1}
        print(f"=== {args.device}: serving {args.windows} windows "
              f"(K={args.scan_k}, {args.policy} policy) with online "
              "retraining behind each decide launch ===")
        sys1 = build(args, dev, tcfg)
        half = (args.windows // 2 // args.scan_k) * args.scan_k
        sys1.run_windows(half)
        st = sys1.train_stats()
        print(f"after {half} windows: dispatched {st['dispatched']} train "
              f"steps, applied {st['applied']}, policy_version "
              f"{sys1.policy_version()}, loss {st['last_loss']:.4f}")
        w_crash = sys1.snapshot_policy()
        v_crash = sys1.policy_version()
        sys1.stop()
        print(f"-- simulated crash at version {v_crash} --")

        # restart: a fresh system restores the newest policy + optimizer
        # snapshot, keeps serving, and version numbering continues
        sys2 = build(args, dev, tcfg)
        restored = sys2.restore_training()
        if restored is None:
            raise SystemExit("no checkpoint found")
        step, _, extra = restored
        print(f"-- restored applied-step {step}, policy_version "
              f"{extra['policy_version']} --")
        live = sys2.snapshot_policy()
        if sys2.policy_version() != v_crash or not all(
                torch.equal(live[k], w_crash[k]) for k in w_crash):
            raise SystemExit("the restored carry is not the crashed one")

        sys2.run_windows(args.windows - half)
        st2 = sys2.train_stats()
        print(f"after restart: applied {st2['applied']} total, "
              f"policy_version {sys2.policy_version()}, "
              f"loss {st2['last_loss']:.4f}")
        if sys2.policy_version() <= v_crash:
            raise SystemExit("training must continue after the restore")

        # attribution: the replay ring records the policy behind each action
        versions = sys2.export_replay("demo")["version"][0]
        print("replay version column (env 0):", versions)
        if not (np.diff(versions) >= 0).all():
            raise SystemExit("versions must be monotone in time")
        sys2.stop()
    print("OK: online retraining rides the decide path, survives a crash, "
          "and every logged action is version-attributed.")


if __name__ == "__main__":
    main()
