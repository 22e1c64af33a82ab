"""Serving launcher: continuous-batching engine over a selected arch —
port of ``repro.launch.serve``.

``python -m repro_torch.launch.serve --arch qwen3-0.6b`` (on the card;
``--device cpu`` runs on the CPU). Every token-input architecture of the
registry serves (dense, RG-LRU, RWKV-6, MoE and ``vlm``, whose requests
carry tokens only); ``musicgen-medium`` takes frame embeddings, which the
engine refuses. Weights are random, drawn from a
``torch.Generator`` seeded with 0; prompts come from ``numpy``'s
``RandomState(0)`` as in the reference. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(args.arch)
    model = LM(cfg, device=args.device, seed=0)
    engine = ServeEngine(model, args.slots, args.max_seq)

    rng = np.random.RandomState(0)
    reqs = [Request(rid=i,
                    prompt=rng.randint(1, cfg.vocab_size,
                                       (args.prompt_len,)).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    engine.run_until_drained(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.tokens) for r in reqs)
    print(json.dumps({
        "requests": len(reqs), "completed": done, "tokens": toks,
        "wall_s": round(dt, 3),
        "tok_per_s": round(toks / dt, 1),
        "engine": engine.stats,
    }, indent=1))
    if done != len(reqs):
        raise SystemExit(f"{len(reqs) - done} requests did not complete")


if __name__ == "__main__":
    main()
