"""GQA attention layer: init, full-sequence apply (prefill, with cache
emission; self- or cross-attention) and single-token decode apply (over a
cache it writes, or, for cross-attention, one it only reads). The flash
and decode kernels are reached through ``kernels/ops.py``.

Parameters keep the reference's layout: q/k/v projections stored as
(D, H, dh) and the output projection as (H, dh, D), so heads stay a
separate dimension.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import LSE_EMPTY
from repro_torch.models.layers import apply_rope, dense_init, weight
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import (constrain_act, is_dtensor,
                                           local_product)

Tree = dict


def attn_init(gen: torch.Generator, cfg, dtype, device) -> Tree:
    H, Hkv, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    p = {}
    for name, h in (("q", H), ("k", Hkv), ("v", Hkv)):
        pp = dense_init(gen, D, h * dh, dtype, device, bias=cfg.qkv_bias)
        pp["w"] = pp["w"].reshape(D, h, dh)
        if cfg.qkv_bias:
            pp["b"] = pp["b"].reshape(h, dh)
        p[name] = pp
    po = dense_init(gen, H * dh, D, dtype, device)
    po["w"] = po["w"].reshape(H, dh, D)
    p["o"] = po
    return p


def _into_heads(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., D) by a (D, H, dh) weight: ``einsum(eq)``; on DTensors the
    product with the (D, H·dh) view, through which DTensor keeps the
    heads' split (einsum's own reshapes flatten a split dim behind
    another, which DTensor replicates or refuses)."""
    if is_dtensor(w):
        from torch.distributed.tensor import Partial, Replicate, Shard
        return local_product(
            lambda x, w: (x @ w.flatten(1)).unflatten(-1, tuple(w.shape[1:])),
            x, [w], Replicate(), Shard(x.dim() - 1), Partial())
    return torch.einsum(eq, x, w)


def _from_heads(eq: str, o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """o (..., H, dh) by an (H, dh, D) weight, as ``_into_heads``."""
    if is_dtensor(w):
        from torch.distributed.tensor import Partial, Shard
        return local_product(lambda o, w: o.flatten(-2) @ w.flatten(0, 1),
                             o, [w], Shard(o.dim() - 2), Partial(),
                             Shard(o.dim() - 2))
    return torch.einsum(eq, o, w)


def _proj(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    y = _into_heads("bsd,dhe->bshe", x, weight(p))
    if "b" in p:
        y = y + p["b"]
    return y


def attn_apply(p: Mapping, x: torch.Tensor, cfg, *, positions: torch.Tensor,
               causal: bool = True, window: Optional[int] = None,
               kv_x: Optional[torch.Tensor] = None,
               impl: Optional[str] = None, return_kv: bool = False):
    """Full-sequence attention. x: (B, S, D); positions: (B, S). With
    ``kv_x`` (B, Sk, D), the encoder output, it is cross-attention: k and v
    are projected from ``kv_x`` and, as in the reference, neither side gets
    RoPE."""
    src = x if kv_x is None else kv_x
    q = constrain_act(_proj(p["q"], x), ("batch", "seq", "heads", "head_dim"))
    k = constrain_act(_proj(p["k"], src),
                      ("batch", "seq", "kv_heads", "head_dim"))
    v = constrain_act(_proj(p["v"], src),
                      ("batch", "seq", "kv_heads", "head_dim"))
    if kv_x is None:                       # self-attention: RoPE both sides
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.attention(q, k, v, causal=causal, window=window, impl=impl)
    y = constrain_act(_from_heads("bshe,hed->bsd", out, weight(p["o"])),
                      ("batch", "seq", None))
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(p: Mapping, x: torch.Tensor, cfg, *, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: int,
                window: Optional[int] = None, cross: bool = False,
                impl: Optional[str] = None) -> torch.Tensor:
    """One-token decode. x: (B, D); cache_k/v: (B, S, Hkv, dh), written in
    place at ``pos`` (the tokens so far). As ``dynamic_update_slice`` does
    in the reference, the write is clamped to S - 1 when ``pos >= S``,
    while the valid length stays ``pos + 1``. With ``cross`` the cache
    holds the encoder's keys and values: it is read, not written, every
    row attends over all S of them, and the query gets no RoPE. Returns y
    (B, D). A cache whose keys the rules split over ranks is written by
    the rank whose block holds the position, and read by each rank over
    its block, the ranks' partials merged (``ops.decode_partitioned``)."""
    B = x.shape[0]
    S = cache_k.shape[1]
    q = _into_heads("bd,dhe->bhe", x, weight(p["q"]))
    if "b" in p["q"]:
        q = q + p["q"]["b"]
    if cross:
        kv_len = torch.full((B,), S, dtype=torch.int32, device=x.device)
    else:
        k_new = _into_heads("bd,dhe->bhe", x, weight(p["k"]))
        v_new = _into_heads("bd,dhe->bhe", x, weight(p["v"]))
        if "b" in p["k"]:
            k_new = k_new + p["k"]["b"]
            v_new = v_new + p["v"]["b"]
        posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q[:, None], posv, cfg.rope_theta)[:, 0]
        k_new = apply_rope(k_new[:, None], posv, cfg.rope_theta)[:, 0]
        at = min(pos, S - 1)
        write_row(cache_k, at, k_new)
        write_row(cache_v, at, v_new)
        kv_len = torch.full((B,), pos + 1, dtype=torch.int32,
                            device=x.device)
    if window is not None:
        lo = torch.clamp(kv_len - window, min=0)
        if is_dtensor(q):
            out = ops.decode_partitioned(
                window_partial, q, cache_k, cache_v, lo, kv_len,
                lambda q, k, v, lo, n: window_partial(q, k, v, lo, n, 0)[0])
        else:
            out = window_partial(q, cache_k, cache_v, lo, kv_len, 0)[0]
    else:
        out = ops.decode_attention(q, cache_k, cache_v, kv_len, impl=impl)
    return _from_heads("bhe,hed->bd", out, weight(p["o"]))


def write_row(cache: torch.Tensor, at: int, row: torch.Tensor) -> None:
    """cache[:, at] = row, in place: cache (B, S, Hkv, dh), row (B, Hkv,
    dh). A DTensor cache whose keys the rules split over ranks is written
    on the rank whose block holds ``at`` alone, the row laid out as the
    cache's batch and heads first."""
    if not is_dtensor(cache) or sh.split_entry(cache, 1) is None:
        cache[:, at] = row.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    target = [Shard(q.dim - (q.dim > 1)) if isinstance(q, Shard) and q.dim
              != 1 else Replicate() for q in cache.placements]
    local = row.redistribute(mesh, target).to_local()
    r, _ = sh.block_index(sh.split_entry(cache, 1), mesh)
    block = cache.to_local()
    Sb = block.shape[1]
    if r * Sb <= at < (r + 1) * Sb:
        block[:, at - r * Sb] = local.to(block.dtype)


def window_partial(q: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, lo: torch.Tensor,
                   kv_len: torch.Tensor, s0: int):
    """Decode attention over the keys [lo, kv_len) of a block of the cache
    whose first key is at position s0: a masked softmax over the block in
    plain PyTorch, as the reference computes it outside any kernel (O(S)
    memory — decode is cheap). Returns (out (B, Hq, dh) in q's dtype, lse
    (B, Hq) f32, ``LSE_EMPTY`` where the block holds no key of the
    range)."""
    B, S, Hkv, dh = cache_k.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    s = s0 + torch.arange(S, device=q.device)[None, :]
    valid = (s >= lo[:, None]) & (s < kv_len[:, None])
    qf = q.float().reshape(B, Hkv, G, dh) * dh ** -0.5
    logits = torch.einsum("bhgd,bshd->bhgs", qf, cache_k.float())
    logits = torch.where(valid[:, None, None], logits, -1e30)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m) * valid[:, None, None]
    l = p.sum(-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, cache_v.float()) / torch.where(
        l == 0, 1.0, l)[..., None]
    lse = torch.where(l == 0, LSE_EMPTY, m[..., 0] + torch.log(
        torch.where(l == 0, 1.0, l)))
    return out.reshape(B, Hq, dh).to(q.dtype), lse.reshape(B, Hq)
