"""LM decode server: continuous batching over a shared KV-cache pool.

Slot-based continuous batching: the server holds a fixed (n_slots, max_len)
cache; finished sequences free their slot and a queued request claims it
on the next step, so every step runs at the same shapes.

The cache's length is global, as in the JAX package's server: slots
advance in lock-step, a sequence admitted into a freed slot starts at the
current global offset and attends to its slot's earlier entries below it,
and once the length reaches ``max_len - 1`` every later sequence ends
after one token.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass
class SeqState:
    rid: int
    tokens: list
    remaining: int
    done: bool = False


class DecodeServer:
    """Greedy by default (``torch.argmax``: the first index on ties, as
    ``jnp.argmax``). The cache lives on the parameters' device."""

    def __init__(self, params, cfg: T.LMConfig, n_slots: int = 8,
                 max_len: int = 512, sample: Callable | None = None):
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.sample = sample or (lambda logits: torch.argmax(logits, dim=-1))
        self.device = params["embed"].device
        self.cache = T.init_cache(cfg, n_slots, max_len, device=self.device)
        self.slots: list[SeqState | None] = [None] * n_slots
        self.queue: list[SeqState] = []
        self.completed: list[SeqState] = []

    def submit(self, rid: int, prompt_token: int, n_tokens: int):
        self.queue.append(SeqState(rid, [prompt_token], n_tokens))

    def _admit(self):
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.pop(0)

    def step(self) -> int:
        """One decode step for every active slot; returns #active."""
        self._admit()
        active = [s for s in self.slots if s is not None]
        if not active:
            return 0
        tok = np.zeros((self.n_slots, 1), np.int64)
        for i, s in enumerate(self.slots):
            if s is not None:
                tok[i, 0] = s.tokens[-1]
        logits, self.cache = T.decode_step(self.params, self.cfg, self.cache,
                                           torch.from_numpy(tok).to(self.device))
        nxt = self.sample(logits).cpu().numpy()  # the step's one wait on the device
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.tokens.append(int(nxt[i]))
            s.remaining -= 1
            if s.remaining <= 0 or self.cache["len"] >= self.max_len - 1:
                s.done = True
                self.completed.append(s)
                self.slots[i] = None  # continuous batching: slot freed
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> list[SeqState]:
        steps = 0
        while (self.queue or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed
