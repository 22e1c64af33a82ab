"""Time ``harmonize_segment``'s scatter branch in several source trees on one
card, in turns.

    python3 tools/segment_ab.py OTHER_TREE [OTHER_TREE ...]

Each OTHER_TREE is another checkout of the repository (for example the
parent commit unpacked with ``git archive`` into ``build/``). Each turn is
a fresh process that imports that tree's ``repro_torch.core.harmonize``
and calls ``harmonize_segment`` on the card at windows past the dense
branch (M*T > 8192), with inputs made from one seed: per call, the time
from issue to completion (CUDA events; the op is a chain of small
launches, so this is mostly the host's launch path), the card's busy time
and its number of device activities (profiler), and whether two calls
agree bit for bit. The turns run the other trees in order, this tree
twice, then the other trees in reverse. One JSON line per measurement,
then a summary line with each tree's medians. Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (E, S, M, T): the card test's window, the E = 256 system's rows, and
# both at a long window (2000 ticks)
SHAPES = [(8, 8, 128, 128), (256, 8, 128, 128), (8, 8, 128, 2000),
          (256, 8, 128, 2000)]
AGGS = ("mean", "last")
TICK_S = 60.0


def worker(tree: Path) -> None:
    sys.path[:0] = [str(tree / "src"), str(HERE)]
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core import harmonize as hz
    from repro_torch.core.frame import RawWindow

    if not torch.cuda.is_available():
        raise SystemExit("segment_ab: no CUDA device")
    dev = torch.device("cuda")
    for E, S, M, T in SHAPES:
        rng = np.random.RandomState(0)
        raw = RawWindow(
            torch.tensor(rng.normal(5, 2, (E, S, M)).astype(np.float32),
                         device=dev),
            torch.tensor(rng.uniform(-TICK_S, (T + 1) * TICK_S,
                                     (E, S, M)).astype(np.float32),
                         device=dev),
            torch.tensor(rng.rand(E, S, M) > 0.3, device=dev))
        grid = hz.tick_grid(torch.zeros((E,), device=dev), TICK_S, T)
        for agg in AGGS:
            def call():
                return hz.harmonize_segment(raw, grid, TICK_S, agg)
            a, b = call(), call()
            same = bool(torch.equal(a[1], b[1])) and cs.bits_equal(a[0],
                                                                   b[0])
            wall = cs.call_ms(call, reps=30)
            busy = cs.device_ms(call)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            acts = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
            cs.emit({"tree": str(tree), "E": E, "S": S, "M": M, "T": T,
                     "agg": agg, "call_us": wall * 1e3,
                     "device_us": None if busy is None else busy * 1e3,
                     "device_activities": acts,
                     "two_calls_bit_equal": same})


def _median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", type=Path, nargs="+")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker.resolve())
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    others = [p.resolve() for p in args.others]
    turns = others + [HERE, HERE] + others[::-1]
    readings: dict = {}
    for tree in turns:
        proc = subprocess.run(
            [sys.executable, __file__, *map(str, others), "--worker",
             str(tree)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                print(line, flush=True)
                key = f"{row['E']}x{row['S']}x{row['M']}x{row['T']}/" \
                      f"{row['agg']}"
                side = "change" if tree == HERE else row["tree"]
                readings.setdefault(key, {}).setdefault(side, []).append(row)
    summary = {
        key: {side: {"call_us": statistics.median(r["call_us"] for r in rs),
                     "device_us": _median(r["device_us"] for r in rs),
                     "device_activities": rs[0]["device_activities"],
                     "two_calls_bit_equal": all(r["two_calls_bit_equal"]
                                                for r in rs)}
              for side, rs in by_side.items()}
        for key, by_side in readings.items()}
    print(json.dumps({"segment_ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
