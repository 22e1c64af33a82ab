"""Training launcher — port of ``repro.launch.train``:

    python -m repro_torch.launch.train --arch qwen3-0.6b:smoke [--device cpu]

Trains on the synthetic LM stream (``data.pipeline``), checkpointing into
``--ckpt-dir``; run again with the same directory, it resumes from the
newest complete checkpoint at the saved batch. The card is the default;
``--device cpu`` asks for the CPU. As the reference, it trains on the
smoke mesh ((1, 1) over the device), or with ``--production-mesh`` on the
(16, 16) pod mesh, which needs 256 devices and raises ``RuntimeError``
with fewer; ``--set key=value`` overrides a ``ShardingConfig`` field
(``--set layout=tp``). Prints one JSON object.
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
                    help="use the 16x16 pod mesh (needs 256 devices)")
    ap.add_argument("--set", action="append", default=[],
                    help="ShardingConfig override key=value")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import (ShapeConfig, ShardingConfig,
                                          TrainConfig, apply_overrides)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
    from repro_torch.train.loop import train

    cfg = get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    mesh = make_production_mesh(device=args.device) if args.production_mesh \
        else make_smoke_mesh(device=args.device)
    perf = apply_overrides(ShardingConfig(remat_policy=args.remat), args.set)
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

    res = train(cfg, shape, mesh, perf=perf, tcfg=tcfg, on_step=log)
    print(json.dumps({
        "steps_run": res.steps_run, "final_step": res.final_step,
        "first_loss": res.losses[0] if res.losses else None,
        "last_loss": res.losses[-1] if res.losses else None,
        "restored_from": res.restored_from,
        "mean_step_s": sum(res.step_times) / max(len(res.step_times), 1),
    }, indent=1))


if __name__ == "__main__":
    main()
