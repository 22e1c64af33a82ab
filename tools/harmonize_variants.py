"""Time the harmonize kernel beside a variant of its own source, on one card.

    python3 tools/harmonize_variants.py

Builds ``src/repro_torch/kernels/harmonize/csrc/harmonize.cu`` twice into
``build/variants/``: as committed (lanes that hit the same tick find each
other through an ``atomicOr`` mask per tick in shared memory) and with that
grouping replaced by ``__match_any_sync``. Both must give the same bits.
Then it times both at ``chip_smoke.py``'s harmonize shapes (the path's
2048 rows of 32 samples into 8 ticks, the fleet's 32768 of 128 into 64),
staged float4 loads and scalar loads, in turns (committed, variant,
variant, committed), with ``chip_smoke.device_ms``. Prints the card's name
and power limit, one JSON line per shape, then a summary line. Needs one
NVIDIA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SRC = REPO / "src/repro_torch/kernels/harmonize/csrc/harmonize.cu"
OUT = REPO / "build" / "variants"
GROUPING = """\
      if (key >= 0) atomicOr(masks + slot, 1u << lane);
      __syncwarp();
      const unsigned grp = key >= 0 ? masks[slot] : 0u;
      __syncwarp();   // every lane has its group before a mask is cleared
"""
MATCH = """\
      const unsigned same = __match_any_sync(kFull, key);
      const unsigned grp = key >= 0 ? same : 0u;
"""


def build(name: str, text: str):
    OUT.mkdir(parents=True, exist_ok=True)
    text = text.replace('#include "../../row_io.cuh"',
                        f'#include "{_build._PKG / "row_io.cuh"}"')
    src, lib = OUT / f"harmonize_{name}.cu", OUT / f"harmonize_{name}.so"
    src.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    so.harmonize_launch.argtypes = _build.SIGNATURES["harmonize_launch"]
    so.harmonize_launch.restype = ctypes.c_int
    return so


def main() -> int:
    if not torch.cuda.is_available():
        print("harmonize_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    text = SRC.read_text()
    if GROUPING not in text:
        raise RuntimeError("harmonize.cu no longer holds the atomicOr "
                           "grouping this tool replaces")
    libs = {"committed": build("committed", text),
            "match_any": build("match_any", text.replace(GROUPING, MATCH))}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}
    for label, (e, s, m, t) in (("path", (256, 8, 32, 8)),
                                ("fleet", (4096, 8, 128, 64))):
        ts = (torch.rand((e, s, m), generator=g, device=dev) * (t + 1.5)
              - 0.5) * cs.TICK_S
        v = torch.randn((e, s, m), generator=g, device=dev)
        ok = torch.rand((e, s, m), generator=g, device=dev) < 0.8
        ws = (torch.rand((e,), generator=g, device=dev) - 0.5) * cs.TICK_S
        times: dict = {}
        outs = []
        for name in ("committed", "match_any", "match_any", "committed"):
            for vec in (1, 0):
                out = torch.empty((e, s, t), device=dev)
                obs = torch.empty((e, s, t), dtype=torch.bool, device=dev)

                def call(lib=libs[name], out=out, obs=obs, vec=vec):
                    _build.check(lib.harmonize_launch(
                        v.data_ptr(), ts.data_ptr(), ok.data_ptr(),
                        ws.data_ptr(), out.data_ptr(), obs.data_ptr(), e, s,
                        m, t, cs.TICK_S, vec, _build.stream_ptr(dev)),
                        name)
                ms = cs.device_ms(call)
                if ms is None:
                    raise RuntimeError(f"{label}: no device time traced")
                key = f"{name}_{'float4' if vec else 'scalar'}_us"
                times.setdefault(key, []).append(ms * 1e3)
                outs.append((out, obs))
        same = all(cs.bits_equal(o, outs[0][0])
                   and torch.equal(b, outs[0][1]) for o, b in outs)
        if not same:
            raise RuntimeError(f"{label}: the variants' outputs differ")
        row = {k: statistics.median(x) for k, x in times.items()}
        cs.emit({"shape": label, "R": e * s, "M": m, "T": t,
                 "bit_equal": same, "us": times})
        summary[label] = row
    cs.emit({"harmonize_variants": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
