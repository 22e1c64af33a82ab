"""Time kernels of two source trees on one card, in turns.

    python3 tools/kernel_ab.py PARENT_TREE [--kernels locf,window_agg]

PARENT_TREE is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/``). Each turn is a fresh
process that builds that tree's kernels and times them with
``chip_smoke.py``'s cases (this tree's definitions: the same shapes and,
from the same seed, the same inputs) and its profiler timer, then drives
one profiled scan batch of the E=256 system (``chip_smoke.make_system``)
for its count of device activities. The turns run parent, this tree, this
tree, parent. One JSON line per measurement, then a summary line: each
kernel's device microseconds per tree (two readings a turn, each the
mean of 20 calls) and the scan batch's device activities. Needs one
NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def worker(tree: Path, names: list[str]) -> None:
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
    for case in cs.kernel_cases(dev, g):
        if case["name"] not in names:
            continue
        ms = [cs.device_ms(case["kernel"]) for _ in range(2)]
        cs.emit({"tree": str(tree), "kernel": case["name"],
                 "shape": case["shape"], **case["dims"],
                 "us": [x * 1e3 for x in ms if x is not None]})
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
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = args.kernels.split(",")
    if args.worker:
        worker(args.worker.resolve(), names)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    trees = {"parent": args.parent.resolve(), "change": HERE}
    times: dict = {}
    activities: dict = {}
    for side in ("parent", "change", "change", "parent"):
        proc = subprocess.run(
            [sys.executable, __file__, str(trees["parent"]), "--kernels",
             args.kernels, "--worker", str(trees[side])],
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
            elif row.get("phase") == "scan_profile":
                activities.setdefault(side, []).append(row["device_kernels"])
    summary = {k: {side: dict(us=v, median_us=statistics.median(v))
                   for side, v in t.items()} for k, t in times.items()}
    print(json.dumps({"kernel_ab": summary,
                      "scan_device_activities": activities}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
