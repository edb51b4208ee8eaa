"""Serving engine: continuous-batched decode driven by the Meili data plane.

Requests are flows (paper §5.1.2): each request's tokens stay on its assigned
pipeline instance; when a pipeline saturates, new requests spill to the
instance with the most available capacity; completed sequences free slots
(continuous batching). Per-instance KV caches play the per-pipeline
ring-buffer role (fixed-capacity, single-writer).

As in the reference, every step feeds each active slot the last token of
its prompt-plus-output, and one cache position (``cache["pos"]``) is shared
by all slots of an instance, whenever they were admitted; a freed slot is
not reset either, so a mamba model's next request in that slot starts from
the previous occupant's SSM state and conv tails. The reference
pins its decode to the blocked jnp path, since its Pallas kernels run only
on a TPU; here ``impl=None`` runs the decode-attention kernel on the card
and ``impl="torch"`` the plain version (mamba decode is plain PyTorch
either way, as the reference's is).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.registry import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    # top-1 minus top-2 logit of each output token: how far each greedy
    # choice was from a tie (runs on two backends may differ only there).
    # It comes from the same top-2 reduction that picks the token.
    margins: List[float] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens


class PipelineInstance:
    """One replicated pipeline: a slot-ed KV cache + decode step."""

    def __init__(self, model: Model, params, slots: int, max_len: int,
                 dtype=torch.float32, impl: Optional[str] = None):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.impl = impl
        self.cache = model.init_cache(slots, max_len, dtype)
        self.active: Dict[int, Request] = {}     # slot -> request
        self.free = list(range(slots))

    @property
    def available(self) -> int:
        return len(self.free)

    def admit(self, req: Request) -> bool:
        if not self.free:
            return False
        slot = self.free.pop()
        self.active[slot] = req
        return True

    def step(self) -> None:
        if not self.active:
            return
        tokens = np.zeros((self.slots,), np.int64)
        for slot, req in self.active.items():
            seq = req.prompt + req.out
            tokens[slot] = seq[-1]
        logits, self.cache = self.model.decode_step(
            self.params, self.cache,
            torch.from_numpy(tokens).to(self.model.device), impl=self.impl)
        # one reduction and one copy to the host: the greedy token and its
        # margin over the runner-up
        top2 = logits.topk(2, dim=-1)
        host = torch.stack((top2.indices[:, 0].double(),
                            (top2.values[:, 0] - top2.values[:, 1]).double()))
        nxt, margin = host.cpu().numpy()
        finished = []
        for slot, req in self.active.items():
            req.out.append(int(nxt[slot]))
            req.margins.append(float(margin[slot]))
            if req.done:
                finished.append(slot)
        for slot in finished:
            del self.active[slot]
            self.free.append(slot)


class ServingEngine:
    """N pipeline instances + flow-sticky admission (Meili TO semantics)."""

    def __init__(self, model: Model, params, num_pipelines: int,
                 slots_per_pipeline: int = 8, max_len: int = 128,
                 dtype=torch.float32, impl: Optional[str] = None):
        self.pipelines = [
            PipelineInstance(model, params, slots_per_pipeline, max_len,
                             dtype, impl)
            for _ in range(num_pipelines)]
        self.pending: List[Request] = []
        self.completed: List[Request] = []

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def step(self) -> None:
        # Admission: highest-available-capacity pipeline first (paper §5.2).
        still = []
        for req in self.pending:
            cand = max(self.pipelines, key=lambda p: p.available)
            if not cand.admit(req):
                still.append(req)
        self.pending = still
        for p in self.pipelines:
            before = list(p.active.values())
            p.step()
            for req in before:
                if req.done and req not in self.completed:
                    self.completed.append(req)

    def run(self, max_steps: int = 256) -> List[Request]:
        for _ in range(max_steps):
            if not self.pending and all(not p.active for p in self.pipelines):
                break
            self.step()
        return self.completed
