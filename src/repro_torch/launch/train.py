"""Training launcher — port of ``repro.launch.train`` on one device:

    python -m repro_torch.launch.train --arch qwen3-0.6b:smoke [--device cpu]

Trains on the synthetic LM stream (``data.pipeline``), checkpointing into
``--ckpt-dir``; run again with the same directory, it resumes from the
newest complete checkpoint at the saved batch. The card is the default;
``--device cpu`` asks for the CPU. ``--production-mesh`` and ``--set``
(the reference's pod mesh and sharding overrides) are the model-sharding
half of the port, not there yet, and are refused. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=("none", "dots",
                                                         "full"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="refused: the model-sharding half of the port")
    ap.add_argument("--set", action="append", default=[],
                    help="refused: ShardingConfig overrides")
    args = ap.parse_args(argv)
    if args.production_mesh or args.set:
        ap.error("--production-mesh and --set shard the model over a mesh; "
                 "the port trains on one device (the model-sharding half "
                 "is not ported yet)")

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.train.loop import train

    cfg = get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir,
                       microbatches=args.micro, remat_policy=args.remat)

    def log(step, metrics):
        if step % max(args.steps // 20, 1) == 0 or step <= 3:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"lr {metrics['lr']:.2e} gnorm {metrics['grad_norm']:.3f} "
                  f"{metrics['time_s']*1e3:.0f} ms", flush=True)

    res = train(cfg, shape, tcfg=tcfg, device=args.device, on_step=log)
    print(json.dumps({
        "steps_run": res.steps_run, "final_step": res.final_step,
        "first_loss": res.losses[0] if res.losses else None,
        "last_loss": res.losses[-1] if res.losses else None,
        "restored_from": res.restored_from,
        "mean_step_s": sum(res.step_times) / max(len(res.step_times), 1),
    }, indent=1))


if __name__ == "__main__":
    main()
