"""Batched serving engine (the counterpart of ``src/repro/serve/engine.py``).

A continuous-batching greedy decode loop over the model's
:func:`~repro_torch.models.lm.decode_step`, with admission control and
Equilibrium page balancing from :class:`.paged_kv.PagedKVPool`: the
request lifecycle admit → prompt → decode → finish → release.  It runs
where the model's parameters lie: on the card unless the model is on the
CPU.

The reference's behaviour is kept as it is, quirks included: one cache
``len`` for all slots, never reset, which every decode call advances;
the prompt fed one token per decode call with token 0 in every other
slot, whose caches and SSD states those calls advance too; and
:meth:`ServeEngine.run` returning an empty list.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import LM, decode_step, init_cache, params_from_numpy
from repro_torch.models.common import ModelConfig

from .paged_kv import PagedKVPool, PagedKVSpec


@dataclass
class Request:
    id: int
    prompt: np.ndarray                 # (prompt_len,)
    max_new_tokens: int
    generated: list[int] = field(default_factory=list)
    seq_id: int | None = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ServeEngine:
    """Greedy-decoding engine with a fixed decode batch of slots.

    ``params`` is an :class:`~repro_torch.models.lm.LM`, which the engine
    runs where it lies, or the reference's parameter tree of NumPy
    arrays, which it loads onto the card (raising without one)."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 max_len: int = 256, pool: PagedKVPool | None = None,
                 rebalance_every: int = 64):
        self.cfg = cfg
        self.model = params if isinstance(params, LM) \
            else params_from_numpy(cfg, params)
        self.device = self.model.embed.device
        self.slots = batch_slots
        self.max_len = max_len
        self.cache = init_cache(cfg, batch_slots, max_len, self.device)
        self.active: dict[int, Request] = {}     # slot -> request
        self.queue: list[Request] = []
        self.pool = pool or PagedKVPool(PagedKVSpec(n_chips=batch_slots))
        self.rebalance_every = rebalance_every
        self.steps = 0
        self.migrated_bytes = 0.0

    def _decode(self, tokens: np.ndarray) -> torch.Tensor:
        """One decode call on (slots, 1) host tokens → (slots, V) logits."""
        logits, self.cache = decode_step(
            self.model, self.cache, torch.from_numpy(tokens).to(self.device))
        return logits

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue[0]
            sid = self.pool.admit(len(req.prompt) + req.max_new_tokens)
            if sid is None:
                break                              # pool full: min-gated
            self.queue.pop(0)
            req.seq_id = sid
            self.active[slot] = req
            # the prompt through single-token decode steps, as the
            # reference feeds it
            for tok in req.prompt:
                token_batch = np.zeros((self.slots, 1), np.int64)
                token_batch[slot, 0] = tok
                self._decode(token_batch)

    def step(self) -> dict:
        """One decode step for every active slot; greedy ``argmax`` over
        its logits is the step's one fetch from the device."""
        self._admit()
        if not self.active:
            return {"active": 0, "queued": len(self.queue)}
        tokens = np.zeros((self.slots, 1), np.int64)
        for slot, req in self.active.items():
            last = req.generated[-1] if req.generated else int(req.prompt[-1])
            tokens[slot, 0] = last
        next_tokens = self._decode(tokens).argmax(dim=-1).cpu().numpy()
        finished = []
        for slot, req in list(self.active.items()):
            req.generated.append(int(next_tokens[slot]))
            self.pool.extend(req.seq_id, 1)
            if req.done:
                finished.append(req)
                self.pool.release(req.seq_id)
                del self.active[slot]
        self.steps += 1
        if self.steps % self.rebalance_every == 0:
            plan = self.pool.rebalance()
            self.migrated_bytes += self.pool.migration_bytes(plan)
        return {"active": len(self.active), "queued": len(self.queue),
                "finished": [r.id for r in finished]}

    def run(self, max_steps: int = 1000) -> list[Request]:
        """Step until nothing is active or queued, or ``max_steps``.  The
        list it returns stays empty, as the reference's does."""
        done: list[Request] = []
        for _ in range(max_steps):
            self.step()
            if not self.active and not self.queue:
                break
        return done
