"""Mixture-of-Experts FFN with sort-based capacity dispatch, as the
reference's ``models/moe.py`` (its global-dispatch path).

Routing: softmax top-k, renormalized. Dispatch: tokens are replicated k
ways, sorted by expert id (a stable sort, so tokens keep their order within
an expert), and gathered into a dense (E, C, D) buffer (capacity
C = ceil(T·k/E·cf) rounded up to 128); tokens beyond an expert's capacity
drop (Switch semantics). The expert products are batched matmuls, (E, C, D)
x (E, D, F), left to PyTorch as the reference leaves them to XLA; then each
token sums its gate-weighted expert outputs.

Where the reference's result depends on an order, the port fixes the same
one on every device:
- top-k takes the lower expert id on a tie (``jax.lax.top_k``'s rule): a
  stable descending sort of the probabilities;
- drops past capacity follow the stable sort by expert id;
- the combine adds each token's kept outputs in slot order (ascending
  expert id), each rounded to the output dtype first and the running sum
  rounded after every add, as the reference's scatter-add does; it is a
  gather and k adds, not a scatter, so no float atomics reorder it and two
  calls on the card are bit-equal. The reference also scatters the zeros of
  empty slots onto token 0; adding a zero changes nothing but the sign of
  an exact zero, and the port leaves it out.

The reference's expert-parallel path (``_moe_ep``, ``_dispatch_local``,
``_combine_local``, the ``shard_map`` branch of ``_expert_matmuls``) runs
only on a multi-device mesh; the port runs on one card, where the
resolver (``parallel/sharding.py``) places every expert on it, and that
path is not ported yet (its torch form, an all-to-all over the model
axis's process group, is ROADMAP A30).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal

Tree = Dict


def moe_init(gen: torch.Generator, cfg, dtype, device) -> Tree:
    """router (D, E), gate and up (E, D, F), down (E, F, D): normal with
    1/sqrt(fan-in) scale, drawn in that order."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(D)
    return {
        "router": _normal(gen, (D, E), s, dtype, device),
        "gate": _normal(gen, (E, D, Fd), s, dtype, device),
        "up": _normal(gen, (E, D, Fd), s, dtype, device),
        "down": _normal(gen, (E, Fd, D), 1.0 / math.sqrt(Fd), dtype, device),
    }


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    c = int(math.ceil(T * k / E * cf))
    return max(128, ((c + 127) // 128) * 128)


def route(p: Mapping, xf: torch.Tensor, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities (T, E) f32, and the top-k gates (T, k), renormed,
    and expert ids (T, k) of tokens xf (T, D): logits in the parameters'
    dtype, then f32; ties go to the lower expert id."""
    logits = (xf @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w = top.values[:, :cfg.top_k]
    ids = top.indices[:, :cfg.top_k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, ids


def _expert_matmuls(p: Mapping, xe: torch.Tensor) -> torch.Tensor:
    """(E, C, D) -> (E, C, D) through the three expert products."""
    h = F.silu(torch.bmm(xe, p["gate"])) * torch.bmm(xe, p["up"])
    return torch.bmm(h, p["down"])


def dispatch(ids: torch.Tensor, T: int, E: int, C: int) -> torch.Tensor:
    """Slot (e·C + position within expert e) of each (token, choice) of
    ``ids`` (T, k), E·C where it drops past capacity: the stable sort by
    expert id keeps token order within an expert. No step waits on the
    device (no boolean indexing, no ``bincount``)."""
    k = ids.shape[1]
    eid = ids.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    eid_s = eid[order]
    counts = torch.zeros(E, dtype=eid.dtype, device=eid.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    starts = torch.cumsum(counts, 0) - counts
    slot_in_e = torch.arange(T * k, device=ids.device) - starts[eid_s]
    dest_s = torch.where(slot_in_e < C, eid_s * C + slot_in_e, E * C)
    return torch.empty_like(dest_s).scatter_(0, order, dest_s).reshape(T, k)


def moe_ffn(p: Mapping, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = _capacity(T, k, E, cfg.capacity_factor)
    xf = x.reshape(T, D)
    _, gate_w, ids = route(p, xf, cfg)
    dest = dispatch(ids, T, E, C)                              # (T, k)

    # (E·C,) -> source token, -1 for an empty slot; then gather the tokens.
    # Dropped choices all land on the extra slot E·C, cut off after.
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    src = torch.full((E * C + 1,), -1, dtype=torch.long, device=x.device)
    src = src.scatter_(0, dest.reshape(-1), tok)[:E * C]
    xe = torch.where((src >= 0)[:, None], xf[src.clamp_min(0)],
                     torch.zeros((), dtype=xf.dtype, device=x.device))
    ye = _expert_matmuls(p, xe.reshape(E, C, D)).reshape(E * C, D)

    # combine: each token's kept slots in slot order, gate-weighted, each
    # contribution rounded to the output dtype, then summed one by one
    ye = F.pad(ye, (0, 0, 0, 1))                               # E·C: dropped
    dest, j = dest.sort(dim=1)
    gates = gate_w.gather(1, j) * (dest < E * C)
    contrib = (ye[dest] * gates[..., None]).to(ye.dtype)       # (T, k, D)
    out = torch.zeros((T, D), dtype=ye.dtype, device=x.device)
    for i in range(k):
        out = out + contrib[:, i]
    return out.reshape(B, S, D).to(x.dtype)


def aux_load_balance_loss(p: Mapping, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean fraction x mean
    prob)."""
    D = x.shape[-1]
    logits = (x.reshape(-1, D) @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    ids = torch.argmax(probs, dim=-1)
    frac = F.one_hot(ids, cfg.n_experts).float().mean(dim=0)
    return cfg.n_experts * torch.sum(frac * probs.mean(dim=0))
