"""Serving engine: continuous batching over decode slots — port of
``repro.serve.engine``.

A fixed pool of B slots runs one batched ``decode_step`` per engine tick;
requests are admitted into free slots by feeding their prompt token by
token through single-slot decode steps (the per-sample ``lengths`` keep
each slot's cache rows apart). Finished slots (eos / max tokens) free at
once, so admission and retirement never stall the running batch. Requests
past their deadline retire with partial output, so one stuck request
cannot hold a slot.

Each step merges the advanced cache into the old one per slot with a
``torch.where`` over every batch-leading leaf (K/V, and the RG-LRU and
RWKV states): slots that do not advance keep their cache rows and
lengths. Admission resets a slot's ``lengths`` only, as the reference's
does, so a reused slot of a recurrent model starts from the state its
last request left. The engine feeds token ids, so a model whose frontend
takes ``frames`` (``embeddings``) is refused. Greedy decoding is
``torch.argmax`` (first index on ties, like ``jnp.argmax``); sampling
draws from a
``torch.Generator`` seeded with ``seed`` and does not reproduce JAX's
draws.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (L,) int32
    max_new_tokens: int = 32
    eos_id: int = -1               # -1 = never
    deadline_s: float = 60.0
    submitted_at: float = field(default_factory=time.time)
    tokens: list = field(default_factory=list)
    done: bool = False
    finish_reason: str = ""


def _merge(old, new, adv):
    """Per-slot select of every cache leaf (all lead with the batch)."""
    if isinstance(old, dict):
        return {k: _merge(old[k], new[k], adv) for k in old}
    if isinstance(old, list):
        return [_merge(o, n, adv) for o, n in zip(old, new)]
    m = adv.reshape((adv.shape[0],) + (1,) * (old.dim() - 1))
    return torch.where(m, new, old)


class ServeEngine:
    def __init__(self, model, batch_slots: int, max_seq: int, *,
                 greedy: bool = True, seed: int = 0):
        if model.cfg.frontend == "embeddings":
            raise ValueError(
                f"{model.cfg.name}: the engine feeds token ids, and this "
                "model takes frame embeddings (frontend 'embeddings')")
        self.model = model
        self.device = model.device
        self.B = batch_slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.cache = model.init_cache(batch_slots, max_seq)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self._last_tokens = np.zeros((batch_slots, 1), np.int32)
        self.stats = {"ticks": 0, "tokens_out": 0, "admitted": 0,
                      "retired": 0, "timeouts": 0}

    # ---------------------------------------------------------------- intake
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        """Prefill queued requests into free slots, token by token."""
        for i in range(self.B):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self.stats["admitted"] += 1
            # lengths[i] = 0 kills the slot's old cache rows (every read is
            # masked by slot_positions validity)
            self.cache["lengths"][i] = 0
            # feed prompt[:-1] through decode steps for this slot only;
            # prompt[-1] stays pending so the next tick's logits give the
            # FIRST generated token
            mask = np.zeros((self.B,), np.int32)
            mask[i] = 1
            for t in req.prompt[:-1]:
                toks = self._last_tokens.copy()
                toks[i, 0] = int(t)
                self._step_masked(toks, mask)
            self._last_tokens[i, 0] = int(req.prompt[-1])
            self.slots[i] = req

    def _step_masked(self, tokens: np.ndarray, advance_mask: np.ndarray):
        """One decode step where only masked slots advance."""
        adv = torch.from_numpy(advance_mask > 0).to(self.device)
        toks = torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device)
        logits, new_cache = self.model.decode_step({"tokens": toks},
                                                   self.cache)
        self.cache = _merge(self.cache, new_cache, adv)
        return logits

    # ----------------------------------------------------------------- tick
    def tick(self) -> Dict[int, int]:
        """One engine iteration: admit, decode one token for live slots,
        retire finished/timed-out requests. Returns {rid: token}."""
        self._admit()
        live = np.array([1 if r is not None else 0 for r in self.slots],
                        np.int32)
        if live.sum() == 0:
            return {}
        logits = self._step_masked(self._last_tokens, live)
        self.stats["ticks"] += 1
        if self.greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float(), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        nxt = nxt.to(torch.int32).cpu().numpy()
        out = {}
        now = time.time()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.tokens.append(tok)
            self._last_tokens[i, 0] = tok
            out[req.rid] = tok
            self.stats["tokens_out"] += 1
            timeout = (now - req.submitted_at) > req.deadline_s
            if tok == req.eos_id or len(req.tokens) >= req.max_new_tokens \
                    or timeout:
                req.done = True
                req.finish_reason = ("timeout" if timeout else
                                     "eos" if tok == req.eos_id else "length")
                if timeout:
                    self.stats["timeouts"] += 1
                self.stats["retired"] += 1
                self.slots[i] = None
                self._last_tokens[i, 0] = 0
                self.cache["lengths"][i] = 0
        return out

    def run_until_drained(self, requests: List[Request],
                          max_ticks: int = 10_000) -> List[Request]:
        for r in requests:
            self.submit(r)
        for _ in range(max_ticks):
            self.tick()
            if not self.queue and all(s is None for s in self.slots):
                break
        return requests
