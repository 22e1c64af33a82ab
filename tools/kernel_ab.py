"""Time kernels of two source trees on one card, in turns.

    python3 tools/kernel_ab.py PARENT_TREE [--kernels locf,window_agg]
                               [--shapes path,fleet]

PARENT_TREE is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/``). Each turn is a fresh
process that builds that tree's kernels and times them with
``chip_smoke.py``'s cases (this tree's definitions: the same shapes and,
from the same seed, the same inputs) and its profiler timer, then drives
one profiled scan batch of the E=256 system (``chip_smoke.make_system``)
for its count of device activities. The turns run parent, this tree, this
tree, parent. One JSON line per measurement, then a summary line: each
kernel's device microseconds per tree (two readings a turn, each the
mean of 20 calls; ``us_warm``: one more taken after
``chip_smoke.call_ms``'s 25 calls, the order in which ``chip_smoke.py``'s
phase 3 times, whose event median each line also gives as ``call_us``),
the SHA-256 of each case's output from the seeded inputs per tree
(``same_bytes``: every turn of both trees gave the same bytes) and the
scan batch's device activities. ``--shapes``
keeps only the named cases: a tree older than this one's cases raises on
the inputs it did not take yet (earlier trees refuse float16 and other
head dims in flash_attention, and more than 19,000 ticks in harmonize).
The flash gradient is the kernel ``flash_attention_bwd`` (its cases
``path``, ``train_rg`` and ``d36`` in bfloat16 and ``path_f32`` and
``rg_f32`` in float32, ``chip_smoke.flash_bwd_cases``, and ``32k``,
``chip_smoke.FLASH_BWD_AB_SPECS``; each tree runs the instance its
``ops`` picks for the case, so a tree before the wgmma instance times
its FMA kernels in bfloat16; each timed with the case's own ``reps``
calls, 3, where the others take 20); a tree before it has no
gradient kernel, so time it against a tree that has one (this tree
itself, ``.``, gives four turns of the same code), and leave it out of
``--kernels`` against an older tree. ``--f32-step`` also times, in each
turn, qwen3-0.6b's float32 ZeRO-3 train step on (2, 4) logical shards of
the card at ``chip_smoke.SHARD_F32``'s shape (the training child's float32
twin: one warm-up step, then ``F32_STEPS`` timed, host clock,
synchronized; its gradient on the instance the tree's ``ops`` picks).
Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
F32_STEPS = 3


def f32_step_ms(cs, dev) -> list[float]:
    """Milliseconds of F32_STEPS float32 qwen3-0.6b train steps on (2, 4)
    logical shards, after one warm-up step (chip_smoke's float32 twin)."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMStream, to_device
    from repro_torch.models import LM
    from repro_torch.train import tree as tr

    cfg = dataclasses.replace(get_config(cs.SHARD_QWEN["arch"]),
                              dtype="float32", param_dtype="float32")
    seq, batch = cs.SHARD_F32["seq"], cs.SHARD_F32["batch"]
    params = tr.map_(lambda x: x.detach(), LM(cfg, device=dev, seed=0).params())
    data = to_device(SyntheticLMStream(cfg.vocab_size, batch, seq,
                                       seed=0).make_batch(0), dev)
    step, _, _, ps, os_, bs = cs._sharded_train(
        cfg, ShapeConfig("train", seq, batch, "train"),
        TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10),
        cs._logical_mesh(dev, cs.SHARD_QWEN["mesh"]), params, data)
    step(ps, os_, bs)
    return [cs._sync_ms(lambda: step(ps, os_, bs))[1]
            for _ in range(F32_STEPS)]


def worker(tree: Path, names: list[str], shapes, f32_step=False) -> None:
    """Time ``names`` from ``tree``'s kernels (its ``src`` first on the
    path, so ``chip_smoke``'s cases import its ops)."""
    sys.path[:0] = [str(tree / "src"), str(HERE)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    _build.build()
    g = torch.Generator(device=dev).manual_seed(0)
    bwd = ("flash_attention_bwd" in names) and (cs.FLASH_BWD_SPECS
                                                 + cs.FLASH_BWD_AB_SPECS)
    for case in cs.kernel_cases(dev, g, bwd_specs=bwd or ()):
        if case["name"] not in names or (shapes and
                                         case["shape"] not in shapes):
            continue
        out = case["kernel"]()
        digest = hashlib.sha256()
        for t in (out if isinstance(out, tuple) else (out,)):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        reps = case.get("reps", 20)
        ms = [cs.device_ms(case["kernel"], reps=reps) for _ in range(2)]
        call = cs.call_ms(case["kernel"], reps=reps)
        warm = cs.device_ms(case["kernel"], reps=reps)
        cs.emit({"tree": str(tree), "kernel": case["name"],
                 "shape": case["shape"], **case["dims"],
                 "sha256": digest.hexdigest(),
                 "us": [x * 1e3 for x in ms if x is not None],
                 "us_warm": None if warm is None else warm * 1e3,
                 "call_us": call * 1e3})
    if f32_step:
        cs.emit({"tree": str(tree), "f32_step_ms": f32_step_ms(cs, dev)})
    with tempfile.TemporaryDirectory() as tmp:
        system = cs.make_system("scan", dev, tmp)
        system.run_windows(cs.K)            # warm-up batch
        cs.profile_batch(system)
        system.db.close()
        system.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--kernels", default="locf,window_agg")
    ap.add_argument("--shapes", default="",
                    help="comma-separated case shapes (default: all)")
    ap.add_argument("--f32-step", action="store_true",
                    help="also time the float32 sharded train step")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = args.kernels.split(",")
    shapes = [x for x in args.shapes.split(",") if x]
    if args.worker:
        worker(args.worker.resolve(), names, shapes, args.f32_step)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    trees = {"parent": args.parent.resolve(), "change": HERE}
    times: dict = {}
    hashes: dict = {}
    warm: dict = {}
    activities: dict = {}
    f32_steps: dict = {}
    for side in ("parent", "change", "change", "parent"):
        proc = subprocess.run(
            [sys.executable, __file__, str(trees["parent"]), "--kernels",
             args.kernels, "--shapes", args.shapes, "--worker",
             str(trees[side]), *(["--f32-step"] if args.f32_step else [])],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            print(json.dumps({"side": side, **row}), flush=True)
            if "kernel" in row:
                key = f"{row['kernel']}/{row['shape']}"
                times.setdefault(key, {}).setdefault(side, []).extend(
                    row["us"])
                if row["us_warm"] is not None:
                    warm.setdefault(key, {}).setdefault(side, []).append(
                        row["us_warm"])
                hashes.setdefault(key, {}).setdefault(side, set()).add(
                    row["sha256"])
            elif row.get("phase") == "scan_profile":
                activities.setdefault(side, []).append(row["device_kernels"])
            elif "f32_step_ms" in row:
                f32_steps.setdefault(side, []).extend(row["f32_step_ms"])
    summary = {k: {**{side: dict(us=v, median_us=statistics.median(v),
                                 us_warm=warm.get(k, {}).get(side, []),
                                 sha256=sorted(hashes[k][side]))
                      for side, v in t.items()},
                   "same_bytes": len(set().union(*hashes[k].values())) == 1}
               for k, t in times.items()}
    print(json.dumps({"kernel_ab": summary,
                      "scan_device_activities": activities,
                      **({"f32_step_ms": {
                          side: dict(ms=v, median_ms=statistics.median(v))
                          for side, v in f32_steps.items()}}
                         if f32_steps else {})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
