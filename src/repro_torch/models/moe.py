"""Mixture-of-Experts FFN with sort-based capacity dispatch, as the
reference's ``models/moe.py``.

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

On a live multi-rank mesh (``parallel/sharding.py``: each rank holds its
block of the tokens, parameters are whole on every rank) ``moe_ffn`` takes
the reference's path under the reference's condition, decided on the
global shape of the tokens:

* ``_moe_ep``, expert parallelism, where the tokens are split over both
  the data and the model axis: each rank dispatches its own tokens at a
  per-rank capacity (``_dispatch_local``), an all-to-all over the model
  axis brings each expert's slots to the rank that holds it, its experts'
  weights are gathered over their FSDP axes, the products run, an
  all-to-all takes the outputs back, and the rank combines its own tokens
  (``_combine_local``);
* else the global dispatch, on the tokens gathered from every rank: under
  the baseline layout (experts on the model axis, capacity on data,
  weights FSDP'd) ``_expert_matmuls`` computes the rank's (E/m, C/d, D)
  block with gathered weights and gathers the blocks back, which is what
  GSPMD makes of the reference's ``shard_map``; each rank keeps its
  tokens' rows of the output.

One device, or no live mesh, takes the global path. The collectives are
``parallel/collectives.py``'s; they carry no gradient, so the paths across
ranks run without autograd (prefill and decode), and raise under it.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh

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


def _expert_products(xe: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                     down: torch.Tensor) -> torch.Tensor:
    """(E, C, D) through the three products with weights (E, D, F),
    (E, D, F), (E, F, D)."""
    h = F.silu(torch.bmm(xe, gate)) * torch.bmm(xe, up)
    return torch.bmm(h, down)


def _weight_specs(p: Mapping, rules, mesh):
    """The specs of gate/up (E, D, F) and of down (E, F, D)."""
    return (sh.spec_for(("experts", "embed", "expert_ff"),
                        tuple(p["gate"].shape), rules, mesh),
            sh.spec_for(("experts", "expert_ff", "embed"),
                        tuple(p["down"].shape), rules, mesh))


def _gathered(w: torch.Tensor, spec: sh.PartitionSpec, dim: int,
              mesh) -> torch.Tensor:
    """This rank's block of ``w`` under ``spec`` with its FSDP dim ``dim``
    gathered back: the rank's experts, whole, as the reference's
    ``shard_map`` bodies gather them."""
    fsdp = sh.PartitionSpec(*(e if i == dim else None
                              for i, e in enumerate(spec)))
    return coll.gather_block(sh.block(w, spec, mesh), fsdp, mesh)


def _multi_rank():
    """The installed (mesh, rules) where the mesh is live and holds more
    than one rank, else (None, None)."""
    mesh, rules = sh._ACT["mesh"], sh._ACT["rules"]
    if mesh is None or rules is None or not sh.is_live(mesh) or \
            sh.mesh_size(mesh) == 1:
        return None, None
    return mesh, rules


_WEIGHTS = ("router", "gate", "up", "down")


def _no_grad(*ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "the MoE FFN across ranks has no backward: its collectives "
            "carry no gradient")


def _expert_matmuls(p: Mapping, xe: torch.Tensor) -> torch.Tensor:
    """(E, C, D) -> (E, C, D) through the three expert products.

    On a live multi-rank mesh under the baseline layout (experts on
    'model', capacity on 'data', expert weights FSDP'd on their embed dim),
    the rank computes its (E/m, C/d, D) block of the products with its
    experts' weights gathered over the FSDP axes, as the reference's
    ``shard_map`` branch does, and the blocks are gathered back to the
    whole (E, C, D) on every rank. Any other layout computes the whole
    products on every rank."""
    mesh, rules = _multi_rank()
    if mesh is not None and {"data", "model"} <= set(sh.mesh_axes(mesh)):
        xe_spec = sh.spec_for(("experts", "capacity", None),
                              tuple(xe.shape), rules, mesh)
        w_spec, d_spec = _weight_specs(p, rules, mesh)
        if (xe_spec[0] == "model" and xe_spec[1] is not None
                and w_spec[0] == "model" and w_spec[1] is not None
                and d_spec[0] == "model" and d_spec[2] is not None):
            _no_grad(xe, p["gate"], p["up"], p["down"])
            ye = _expert_products(sh.block(xe, xe_spec, mesh),
                                  _gathered(p["gate"], w_spec, 1, mesh),
                                  _gathered(p["up"], w_spec, 1, mesh),
                                  _gathered(p["down"], d_spec, 2, mesh))
            return coll.gather_block(ye, xe_spec, mesh)
    return _expert_products(xe, p["gate"], p["up"], p["down"])


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


def _combine(ye: torch.Tensor, dest: torch.Tensor, gates: torch.Tensor,
             T: int, D: int) -> torch.Tensor:
    """The combine of expert outputs ye (E·C, D): each token's kept slots
    ``dest`` (T, k), ascending, E·C where a choice dropped, and their
    gates (T, k), 0 where dropped; each contribution rounded to ye's dtype,
    then summed one by one in slot order."""
    ye = F.pad(ye, (0, 0, 0, 1))                               # E·C: dropped
    contrib = (ye[dest] * gates[..., None]).to(ye.dtype)       # (T, k, D)
    out = torch.zeros((T, D), dtype=ye.dtype, device=ye.device)
    for i in range(dest.shape[1]):
        out = out + contrib[:, i]
    return out


def _dispatch_local(xf: torch.Tensor, router: torch.Tensor, cfg):
    """Sort-based capacity dispatch of tokens xf (T, D) at the capacity of
    T tokens, as the reference's. Returns xe (E, C, D), src (E·C,) int32:
    each slot's source token + 1, 0 where empty, and gate_slot (E·C,) f32:
    each slot's combine weight, 0 where empty."""
    T, D = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, k, E, cfg.capacity_factor)
    _, gate_w, ids = route({"router": router}, xf, cfg)
    dest = dispatch(ids, T, E, C).reshape(-1)
    # dropped choices all land on the extra slot E·C, cut off after
    tok = torch.arange(1, T + 1, dtype=torch.int32,
                       device=xf.device).repeat_interleave(k)
    src = torch.zeros(E * C + 1, dtype=torch.int32, device=xf.device)
    src = src.scatter_(0, dest, tok)[:E * C]
    gate_slot = torch.zeros(E * C + 1, dtype=gate_w.dtype, device=xf.device)
    gate_slot = gate_slot.scatter_(0, dest, gate_w.reshape(-1))[:E * C]
    xe = torch.where((src > 0)[:, None], xf[(src.long() - 1).clamp_min(0)],
                     torch.zeros((), dtype=xf.dtype, device=xf.device))
    return xe.reshape(E, C, D), src, gate_slot


def _combine_local(ye_flat: torch.Tensor, src: torch.Tensor,
                   gate_slot: torch.Tensor, T: int, D: int,
                   k: int) -> torch.Tensor:
    """The combine of ``_dispatch_local``'s slots: each of the T tokens
    sums its at most k slots' gate-weighted outputs ye_flat (E·C, D), in
    slot order (``_combine``). The slots of a token are found by a stable
    sort of the slots by token, not by a scatter-add."""
    EC = src.numel()
    dev = src.device
    tok = torch.where(src > 0, src.long() - 1, T)              # T: empty
    order = torch.sort(tok, stable=True).indices
    tok_s = tok[order]
    counts = torch.zeros(T + 1, dtype=torch.long, device=dev).scatter_add_(
        0, tok, torch.ones_like(tok))
    nth = torch.arange(EC, device=dev) - (torch.cumsum(counts, 0)
                                          - counts)[tok_s]
    dest = torch.full((T + 1, k), EC, dtype=torch.long, device=dev)
    dest[tok_s, torch.where(tok_s < T, nth, 0)] = order        # row T: empty
    dest = dest[:T]
    return _combine(ye_flat, dest, F.pad(gate_slot, (0, 1))[dest], T, D)


def _moe_ep(p: Mapping, x: torch.Tensor, cfg, mesh, rules) -> torch.Tensor:
    """Expert parallelism on this rank's tokens x (B_l, S_l, D): local
    dispatch at the per-rank capacity (the standard EP approximation),
    an all-to-all over the model axis to the rank that holds each expert
    (E/m, m·C_l, D), the products with the rank's experts' weights
    gathered over their FSDP axes, the all-to-all back (E, C_l, D), and
    the local combine, as the reference's ``shard_map`` body. The
    parameters are whole on every rank; each takes its block by its mesh
    coordinates, as ``shard_map``'s ``in_specs`` hand it out."""
    _no_grad(x, *(p[k] for k in _WEIGHTS))
    w_spec, d_spec = _weight_specs(p, rules, mesh)
    r_spec = sh.spec_for(("vocab_embed", "none"), tuple(p["router"].shape),
                         rules, mesh)
    Bl, Sl, D = x.shape
    Tl = Bl * Sl
    xe, src, gate_slot = _dispatch_local(
        x.reshape(Tl, D), sh.block(p["router"], r_spec, mesh), cfg)
    xe = coll.all_to_all(xe, mesh, "model", 0, 1)          # (E/m, m·C_l, D)
    ye = _expert_products(xe, _gathered(p["gate"], w_spec, 1, mesh),
                          _gathered(p["up"], w_spec, 1, mesh),
                          _gathered(p["down"], d_spec, 2, mesh))
    ye = coll.all_to_all(ye, mesh, "model", 1, 0)              # (E, C_l, D)
    out = _combine_local(ye.reshape(-1, D), src, gate_slot, Tl, D,
                         cfg.top_k)
    return out.reshape(Bl, Sl, D).to(x.dtype)


def _moe_global(p: Mapping, x: torch.Tensor, cfg) -> torch.Tensor:
    """The global dispatch over all tokens of x (B, S, D)."""
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

    # combine: each token's kept slots in slot order, gate-weighted
    dest, j = dest.sort(dim=1)
    gates = gate_w.gather(1, j) * (dest < E * C)
    out = _combine(ye, dest, gates, T, D)
    return out.reshape(B, S, D).to(x.dtype)


def moe_ffn(p: Mapping, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); on a live multi-rank mesh, x is this
    rank's block of the tokens and so is the result.

    The path is the reference's, decided on the tokens' global shape:
    expert parallelism where the mesh has a data and a model axis, the
    experts divide the model axis, and the tokens are split over both
    axes (batch x seq covering data x model); else the global dispatch on
    the tokens gathered from every rank, each rank keeping its block of
    the output."""
    mesh, rules = _multi_rank()
    if mesh is None:
        return _moe_global(p, x, cfg)
    sizes = sh.mesh_axes(mesh)
    x_spec = sh.token_spec(sh.global_shape(x), rules, mesh)
    if {"data", "model"} <= set(sizes) and \
            cfg.n_experts % sizes["model"] == 0:
        flat = {a for e in x_spec[:2] for a in sh.entry_axes(e)}
        if {"data", "model"} <= flat:
            return _moe_ep(p, x, cfg, mesh, rules)
    _no_grad(x, *(p[k] for k in _WEIGHTS))
    out = _moe_global(p, coll.gather_block(x, x_spec, mesh), cfg)
    return sh.block(out, x_spec, mesh)


def aux_load_balance_loss(p: Mapping, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean fraction x mean
    prob)."""
    D = x.shape[-1]
    logits = (x.reshape(-1, D) @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    ids = torch.argmax(probs, dim=-1)
    frac = F.one_hot(ids, cfg.n_experts).float().mean(dim=0)
    return cfg.n_experts * torch.sum(frac * probs.mean(dim=0))
