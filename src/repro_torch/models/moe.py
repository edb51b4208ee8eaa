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

On a live multi-rank mesh ``moe_ffn`` takes the reference's path under
the reference's condition, decided on the global shape of the tokens:

* ``_moe_ep``, expert parallelism, where the tokens are split over both
  the data and the model axis: each rank dispatches its own tokens at a
  per-rank capacity (``_dispatch_local``), an all-to-all over the model
  axis brings each expert's slots to the rank that holds it, its experts'
  weights are gathered over their FSDP axes, the products run, an
  all-to-all takes the outputs back, and the rank combines its own tokens
  (``_combine_local``): the body of the reference's ``shard_map``;
* else the global dispatch over every token: under the baseline layout
  (experts on the model axis, capacity on data, weights FSDP'd)
  ``_expert_matmuls`` computes the rank's (E/m, C/d, D) block of the
  products with its experts' weights gathered over the FSDP axes, the
  reference's ``shard_map`` branch.

In a partitioned step (``launch/steps.py`` over a DeviceMesh) the tokens
and the parameters are DTensors, the expert weights placed per rank by
the resolver (each rank holds its experts' block). The bodies run under
``local_map`` on the local blocks, and everything trains through
autograd: the collectives of ``parallel/collectives.py`` carry their
adjoints, so the all-to-alls' gradients go back by all-to-all and the
weights' gathers' gradients come back reduce-scattered; a replicated
weight's gradient is partial over the axes whose ranks hold other tokens,
as ``sharding.local_product``'s are. The global dispatch routes every
token on every rank (the same result on each), each rank gathers its
block of the slots and combines its block's outputs into a partial sum
of the output, which the tokens' layout then reduces: GSPMD's layout of
the reference's global path, where no rank holds the whole (E, C, D)
buffer.

Plain tensors on a live mesh (each rank holding its block of the tokens
and whole parameters, ``sharding.set_activation_sharding(...,
tokens=)``) take the same paths, each rank taking its blocks of the
parameters by its mesh coordinates, as ``shard_map``'s ``in_specs`` hand
them out. One device, or no live mesh, takes the global path.
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


def _fsdp_gathered(w: torch.Tensor, spec: sh.PartitionSpec, dim: int,
                  mesh) -> torch.Tensor:
    """A rank's experts' block ``w`` of a weight laid out by ``spec`` with
    its FSDP dim ``dim`` gathered back: the rank's experts, whole, as the
    reference's ``shard_map`` bodies gather them (their gradient comes
    back reduce-scattered)."""
    fsdp = sh.PartitionSpec(*(e if i == dim else None
                              for i, e in enumerate(spec)))
    return coll.gather_block(w, fsdp, mesh)


def _multi_rank():
    """The installed (mesh, rules) where the mesh is live and holds more
    than one rank, else (None, None)."""
    mesh, rules = sh._ACT["mesh"], sh._ACT["rules"]
    if mesh is None or rules is None or not sh.is_live(mesh) or \
            sh.mesh_size(mesh) == 1:
        return None, None
    return mesh, rules


def _baseline(xe_spec, w_spec, d_spec) -> bool:
    """The reference's baseline layout of the expert products: experts on
    'model', capacity split, weights FSDP'd on their embed dim."""
    return (xe_spec[0] == "model" and xe_spec[1] is not None
            and w_spec[0] == "model" and w_spec[1] is not None
            and d_spec[0] == "model" and d_spec[2] is not None)


def _placed(spec: sh.PartitionSpec, mesh, work: sh.PartitionSpec,
            gathered: bool, experts: bool = True):
    """(placements, gradient placements) under ``local_map`` of a weight
    laid out by ``spec`` that meets work (tokens or slots) laid out by
    ``work``: on the axis of its experts (dim 0, where ``experts``) it
    keeps its block; on an FSDP axis it keeps its block where the body
    gathers it (``gathered``; the gather's adjoint sums the gradient) and
    is gathered to a replica first where not; elsewhere it is whole. A
    whole weight's gradient is partial over the axes that split the work
    (their ranks see other tokens), else replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    split = {a for e in work for a in sh.entry_axes(e)}
    pl, grad = [], []
    for a, q in zip(sh.mesh_axes(mesh), sh.live_placements(spec, mesh)):
        if isinstance(q, Shard) and ((experts and q.dim == 0) or gathered):
            pl.append(q)
            grad.append(q)
        else:
            pl.append(Replicate())
            grad.append(Partial() if a in split else Replicate())
    return tuple(pl), tuple(grad)


def _on_blocks(body, work: torch.Tensor, work_spec, weights, mesh,
               gathered: bool):
    """``body(work, *weights)`` on each rank's local blocks under
    ``local_map``: ``work`` at ``work_spec``'s placements (its gradient
    too), each weight (tensor, spec[, experts]) placed by ``_placed``;
    the output as the work."""
    from torch.distributed.tensor.experimental import local_map
    pl = sh.live_placements(work_spec, mesh)
    ins, grads = [pl], [pl]
    for _, spec, *experts in weights:
        a, g = _placed(spec, mesh, work_spec, gathered, *experts)
        ins.append(a)
        grads.append(g)
    return local_map(body, out_placements=list(pl),
                     in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(
        work, *(w[0] for w in weights))


def _expert_matmuls(p: Mapping, xe: torch.Tensor) -> torch.Tensor:
    """(E, C, D) -> (E, C, D) through the three expert products.

    On a live multi-rank mesh under the baseline layout (experts on
    'model', capacity on 'data', expert weights FSDP'd on their embed dim),
    the rank computes its (E/m, C/d, D) block of the products with its
    experts' weights gathered over the FSDP axes, as the reference's
    ``shard_map`` branch does. A DTensor xe gives that block as its own
    (the weights DTensors placed per rank); a plain xe, whole on every
    rank with whole weights, takes its block and the blocks are gathered
    back. Any other layout of a DTensor xe computes each rank's block of
    the products with the weights gathered by DTensor; of a plain xe, the
    whole products on every rank."""
    if sh.is_dtensor(xe):
        mesh, rules = xe.device_mesh, sh.installed()[0]
        xe_spec = sh.spec_for(("experts", "capacity", None),
                              tuple(xe.shape), rules, mesh)
        w_spec, d_spec = _weight_specs(p, rules, mesh)
        gathered = _baseline(xe_spec, w_spec, d_spec)

        def body(xe, gate, up, down):
            if gathered:
                gate, up = (_fsdp_gathered(w, w_spec, 1, mesh)
                            for w in (gate, up))
                down = _fsdp_gathered(down, d_spec, 2, mesh)
            return _expert_products(xe, gate, up, down)
        return _on_blocks(body, xe, xe_spec,
                          [(p["gate"], w_spec), (p["up"], w_spec),
                           (p["down"], d_spec)], mesh, gathered)
    mesh, rules = _multi_rank()
    if mesh is not None and {"data", "model"} <= set(sh.mesh_axes(mesh)):
        xe_spec = sh.spec_for(("experts", "capacity", None),
                              tuple(xe.shape), rules, mesh)
        w_spec, d_spec = _weight_specs(p, rules, mesh)
        if _baseline(xe_spec, w_spec, d_spec):
            ye = _expert_products(
                sh.block(xe, xe_spec, mesh),
                _fsdp_gathered(sh.block(p["gate"], w_spec, mesh), w_spec, 1,
                               mesh),
                _fsdp_gathered(sh.block(p["up"], w_spec, mesh), w_spec, 1,
                               mesh),
                _fsdp_gathered(sh.block(p["down"], d_spec, mesh), d_spec, 2,
                               mesh))
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


def _ep_body(x: torch.Tensor, router: torch.Tensor, gate: torch.Tensor,
             up: torch.Tensor, down: torch.Tensor, cfg, mesh, w_spec,
             d_spec) -> torch.Tensor:
    """The reference's ``_moe_ep`` ``shard_map`` body on a rank's blocks:
    tokens x (B_l, S_l, D), the router, and its experts' weights."""
    Bl, Sl, D = x.shape
    Tl = Bl * Sl
    xe, src, gate_slot = _dispatch_local(x.reshape(Tl, D), router, cfg)
    xe = coll.all_to_all(xe, mesh, "model", 0, 1)          # (E/m, m·C_l, D)
    ye = _expert_products(xe, _fsdp_gathered(gate, w_spec, 1, mesh),
                          _fsdp_gathered(up, w_spec, 1, mesh),
                          _fsdp_gathered(down, d_spec, 2, mesh))
    ye = coll.all_to_all(ye, mesh, "model", 1, 0)              # (E, C_l, D)
    out = _combine_local(ye.reshape(-1, D), src, gate_slot, Tl, D,
                         cfg.top_k)
    return out.reshape(Bl, Sl, D).to(x.dtype)


def _moe_ep(p: Mapping, x: torch.Tensor, cfg, mesh, rules) -> torch.Tensor:
    """Expert parallelism on this rank's tokens: local dispatch at the
    per-rank capacity (the standard EP approximation), an all-to-all over
    the model axis to the rank that holds each expert (E/m, m·C_l, D),
    the products with the rank's experts' weights gathered over their
    FSDP axes, the all-to-all back (E, C_l, D), and the local combine
    (``_ep_body``). A DTensor x runs the body under ``local_map`` on its
    local block and the parameters' (the expert weights placed per rank);
    plain tensors are this rank's block of the tokens and whole
    parameters, of which the rank takes its blocks."""
    w_spec, d_spec = _weight_specs(p, rules, mesh)
    r_spec = sh.spec_for(("vocab_embed", "none"), tuple(p["router"].shape),
                         rules, mesh)

    def body(x, router, gate, up, down):
        return _ep_body(x, router, gate, up, down, cfg, mesh, w_spec, d_spec)
    if not sh.is_dtensor(x):
        return body(x, *(sh.block(p[k], s, mesh) for k, s in (
            ("router", r_spec), ("gate", w_spec), ("up", w_spec),
            ("down", d_spec))))
    x_spec = sh.token_spec(tuple(x.shape), rules, mesh)
    split = {a for e in x_spec for a in sh.entry_axes(e)}
    fsdp = {a for s, d in ((w_spec, 1), (d_spec, 2))
            for a in sh.entry_axes(s[d])}
    if not fsdp <= split:
        raise NotImplementedError(
            f"expert parallelism with weights FSDP'd over {sorted(fsdp)} "
            f"and tokens split over {sorted(split)}: the gathers' adjoint "
            f"would sum repeated gradients")
    return _on_blocks(body, x, x_spec,
                      [(p["router"], r_spec, False), (p["gate"], w_spec),
                       (p["up"], w_spec), (p["down"], d_spec)], mesh,
                      gathered=True)


def _moe_global(p: Mapping, x: torch.Tensor, cfg) -> torch.Tensor:
    """The global dispatch over all tokens of x (B, S, D)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = _capacity(T, k, E, cfg.capacity_factor)
    xf = x.reshape(T, D)
    dest, gates = _route_sorted(p["router"], xf, cfg, C)
    xe = _gather_slots(xf, dest, E, C, 0, E, 0, C)
    ye = _expert_matmuls(p, xe).reshape(E * C, D)
    out = _combine(ye, dest, gates, T, D)
    return out.reshape(B, S, D).to(x.dtype)


def _route_sorted(router: torch.Tensor, xf: torch.Tensor, cfg, C: int):
    """Each token's kept slots ``dest`` (T, k), ascending (E·C where a
    choice dropped), and their gates (T, k), 0 where dropped."""
    T, E = xf.shape[0], cfg.n_experts
    _, gate_w, ids = route({"router": router}, xf, cfg)
    dest, j = dispatch(ids, T, E, C).sort(dim=1)
    return dest, gate_w.gather(1, j) * (dest < E * C)


def _gather_slots(xf: torch.Tensor, dest: torch.Tensor, E: int, C: int,
                  e0: int, El: int, c0: int, Cl: int) -> torch.Tensor:
    """The (El, Cl, D) block at experts e0.., slots c0.. of the slot
    buffer (E, C, D) of tokens xf (T, D) kept at ``dest``: each slot's
    source token, zeros where empty. Dropped choices all land on the
    extra slot E·C, cut off."""
    T, D = xf.shape
    tok = torch.arange(T, device=xf.device).repeat_interleave(dest.shape[1])
    src = torch.full((E * C + 1,), -1, dtype=torch.long, device=xf.device)
    src = src.scatter_(0, dest.reshape(-1), tok)[:E * C].reshape(E, C)
    src = src[e0:e0 + El, c0:c0 + Cl].reshape(-1)
    xe = torch.where((src >= 0)[:, None], xf[src.clamp_min(0)],
                     torch.zeros((), dtype=xf.dtype, device=xf.device))
    return xe.reshape(El, Cl, D)


def _moe_global_partitioned(p: Mapping, x: torch.Tensor, cfg, mesh,
                            rules) -> torch.Tensor:
    """The global dispatch on DTensors: every rank routes every token
    (the same on each), gathers its block of the slot buffer (E, C, D) as
    the slots' layout gives it (``("experts", "capacity", None)``), runs
    its block of the products (``_expert_matmuls``) and combines its
    block's slots into its share of every token's output; the shares'
    sum is reduced into the tokens' layout. The slots' gather and the
    combine make partial gradients of the tokens and gates, summed over
    the axes that split the slots."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = _capacity(T, k, E, cfg.capacity_factor)
    rep = (Replicate(),) * mesh.ndim
    xe_spec = sh.spec_for(("experts", "capacity", None), (E, C, D), rules,
                          mesh)
    xe_pl = sh.live_placements(xe_spec, mesh)
    part = tuple(Partial() if isinstance(q, Shard) else Replicate()
                 for q in xe_pl)
    (ei, ne), (ci, nc) = (sh.block_index(e, mesh) for e in xe_spec[:2])
    El, Cl = E // ne, C // nc
    e0, c0 = ei * El, ci * Cl

    def slots(xr, dest):
        return _gather_slots(xr.reshape(T, D), dest, E, C, e0, El, c0, Cl)

    def combine(ye, dest, gates):
        # each of the block's slots: its token (T where empty) and which of
        # the token's choices it holds; choice i of every token added in
        # pass i, where no token appears twice (no float atomics but on
        # the discarded row T), in slot order as ``_combine`` adds them
        dev = dest.device
        at = lambda v, fill: torch.full((E * C + 1,), fill, dtype=torch.long,
                                        device=dev).scatter_(
            0, dest.reshape(-1), v)[:E * C].reshape(E, C)[
            e0:e0 + El, c0:c0 + Cl].reshape(-1)
        tok = at(torch.arange(T, device=dev).repeat_interleave(k), T)
        nth = at(torch.arange(k, device=dev).repeat(T), 0)
        g = F.pad(gates, (0, 0, 0, 1))[tok, nth]            # 0 where empty
        contrib = (ye.reshape(El * Cl, D) * g[:, None]).to(ye.dtype)
        out = torch.zeros((T + 1, D), dtype=ye.dtype, device=dev)
        for i in range(k):
            out.index_add_(0, torch.where(nth == i, tok, T), contrib)
        return out[:T].reshape(B, S, D)

    xr = x.redistribute(mesh, rep)                 # every token on each rank
    dest, gates = local_map(
        lambda xr, r: _route_sorted(r, xr.reshape(T, D), cfg, C),
        out_placements=(rep, rep), in_placements=(rep, rep),
        device_mesh=mesh, redistribute_inputs=True)(xr, p["router"])
    xe = local_map(slots, out_placements=list(xe_pl),
                   in_placements=(rep, rep), in_grad_placements=(part, rep),
                   device_mesh=mesh, redistribute_inputs=True)(xr, dest)
    ye = _expert_matmuls(p, xe)
    out = local_map(combine, out_placements=list(part),
                    in_placements=(xe_pl, rep, rep),
                    in_grad_placements=(xe_pl, rep, part), device_mesh=mesh,
                    redistribute_inputs=True)(ye, dest, gates)
    return out.redistribute(mesh, x.placements).to(x.dtype)


def moe_ffn(p: Mapping, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); on a live multi-rank mesh, x is this
    rank's block of the tokens (a DTensor, or a plain block of the
    installed tokens) and so is the result.

    The path is the reference's, decided on the tokens' global shape:
    expert parallelism where the mesh has a data and a model axis, the
    experts divide the model axis, and the tokens are split over both
    axes (batch x seq covering data x model); else the global dispatch on
    every token."""
    if sh.is_dtensor(x):
        mesh, rules = x.device_mesh, sh.installed()[0]
        shape = tuple(x.shape)
    else:
        mesh, rules = _multi_rank()
        if mesh is None:
            return _moe_global(p, x, cfg)
        shape = sh.global_shape(x)
    sizes = sh.mesh_axes(mesh)
    x_spec = sh.token_spec(shape, rules, mesh)
    if {"data", "model"} <= set(sizes) and \
            cfg.n_experts % sizes["model"] == 0:
        flat = {a for e in x_spec[:2] for a in sh.entry_axes(e)}
        if {"data", "model"} <= flat:
            return _moe_ep(p, x, cfg, mesh, rules)
    if sh.is_dtensor(x):
        return _moe_global_partitioned(p, x, cfg, mesh, rules)
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
