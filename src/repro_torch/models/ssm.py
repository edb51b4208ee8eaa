"""Mamba-2 block: projections, causal depthwise conv, SSD scan, gating.

As the reference's ``models/ssm.py``: separate projections for z (gate),
x (inner), B, C (state projections, one group) and dt (per head); a causal
depthwise conv over the x and B/C paths; a_t = exp(-exp(A_log)·dt) with
dt = softplus(x W_dt + dt_bias); the SSD scan through ``ops.ssd`` (the
hand-written kernel on the card); an RMS-normed, gated output projection.

Decode carries (conv tails, SSM state h) per layer. ``mamba_decode`` is the
one-token recurrence in plain PyTorch, as the reference's is; it writes the
cache in place.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (_normal, dense_init, project_in,
                                       project_out, rmsnorm, rmsnorm_init)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import constrain_act, is_dtensor

Tree = Dict


def mamba_init(gen: torch.Generator, cfg, dtype, device) -> Tree:
    """The reference's tree: dense layers at 1/sqrt(fan-in) scale, conv
    weights at 1/sqrt(K), and ``A_log``, ``dt_bias``, ``D_skip`` in f32
    whatever ``dtype`` is."""
    D, Din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.conv_kernel
    f32 = torch.float32
    return {
        "z": dense_init(gen, D, Din, dtype, device),
        "x": dense_init(gen, D, Din, dtype, device),
        "B": dense_init(gen, D, N, dtype, device),
        "C": dense_init(gen, D, N, dtype, device),
        "dt": dense_init(gen, D, H, dtype, device),
        "o": dense_init(gen, Din, D, dtype, device),
        "norm": rmsnorm_init(Din, dtype, device),
        "conv_x": _normal(gen, (K, Din), 1.0 / math.sqrt(K), dtype, device),
        "conv_BC": _normal(gen, (K, 2 * N), 1.0 / math.sqrt(K), dtype,
                           device),
        "A_log": torch.zeros((H,), dtype=f32, device=device),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "D_skip": torch.ones((H,), dtype=f32, device=device),
    }


def _conv_rows(pad: torch.Tensor, w: torch.Tensor, S: int) -> torch.Tensor:
    """The last S outputs of a depthwise conv over ``pad`` (B, K-1+S,
    Ch): f32 sums in the reference's order, in pad's dtype."""
    out = torch.zeros((pad.shape[0], S, pad.shape[2]), dtype=torch.float32,
                      device=pad.device)
    for i in range(w.shape[0]):
        out = out + pad[:, i:i + S].float() * w[i].float()
    return out.to(pad.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, Ch), w: (K, Ch); f32 sums in the
    reference's order, cast back to x's dtype. A DTensor x is convolved on
    each rank's block: its batch and channels as x lays them out (w's
    channels alike), its sequence as x lays it out (``conv_seq`` where
    ranks split it, as on a rank's plain block of installed tokens whose
    sequence is split)."""
    if is_dtensor(x):
        return _conv_partitioned(x, w)
    entry = sh.token_seq_entry()
    if entry is not None:
        return conv_seq(x, w, entry, sh.installed()[1])
    K = w.shape[0]
    return _conv_rows(F.pad(x, (0, 0, K - 1, 0)), w, x.shape[1])


def conv_seq(x: torch.Tensor, w: torch.Tensor, entry, mesh) -> torch.Tensor:
    """The causal conv of one rank's block r of a sequence split over
    ``entry``'s axes (plain tensors): every rank's last K-1 rows are
    gathered over the axes (the gather's adjoint returns their gradient),
    and the block is convolved after rank r-1's (zeros on rank 0)."""
    K, S = w.shape[0], x.shape[1]
    if S < K - 1:
        raise ValueError(f"a block of {S} rows is shorter than the conv's "
                         f"{K - 1}-row halo")
    r, n = sh.block_index(entry, mesh)
    tails = coll.gather_dim(x[None, :, S - (K - 1):], entry, mesh, 0)
    # rank 0 takes its zeros from the gathered tails too, so every rank's
    # gradient runs the gather's reduce-scatter
    prev = tails[(r - 1) % n] * float(r > 0)
    return _conv_rows(torch.cat([prev, x], dim=1), w, S)


def _conv_partitioned(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_causal_conv`` under ``local_map``. w's gradient on a rank is
    its block's share of the batch and the sequence: partial over their
    axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x_pl = tuple(q if isinstance(q, Shard) else Replicate()
                 for q in x.placements)
    w_pl = tuple(Shard(1) if q == Shard(2) else Replicate() for q in x_pl)
    w_grad = tuple(Partial() if q in (Shard(0), Shard(1)) else p
                   for q, p in zip(x_pl, w_pl))
    mesh, seq = x.device_mesh, sh.split_entry(x, 1)
    fn = _causal_conv if seq is None else \
        (lambda x, w: conv_seq(x, w, seq, mesh))
    return local_map(fn, out_placements=list(x_pl),
                     in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_pl, w_grad),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def _gates(p: Mapping, xw: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """dt = softplus(x W_dt + dt_bias) and a = exp(-exp(A_log) dt), f32,
    (..., H). torch's softplus returns its input above 20, where JAX's
    ``logaddexp(x, 0)`` differs from it by under 2e-9."""
    dt = F.softplus(project_in(xw, p["dt"]).float() + p["dt_bias"])
    a = torch.exp(-torch.exp(p["A_log"]) * dt)
    return dt, a


def ssd_inputs(p: Mapping, xw: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    """The mixer up to the scan. xw: (B, S, D) normed input. Returns
    (z, xi_pre, bc_pre, xh, a, b, c): the gate, the pre-conv x and B/C
    activations (the decode cache keeps their tails), and the scan's inputs
    x (B, S, H, P), a (B, S, H), b (B, S, H, N) and c, one (B, S, N) tensor
    broadcast over H as a view."""
    B, S, _ = xw.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z = constrain_act(project_in(xw, p["z"]), ("batch", "seq", "ff"))
    xi_pre = constrain_act(project_in(xw, p["x"]), ("batch", "seq", "ff"))
    xi = F.silu(_causal_conv(xi_pre, p["conv_x"]))
    bc_pre = torch.cat([project_in(xw, p["B"]), project_in(xw, p["C"])],
                       dim=-1)
    bc = F.silu(_causal_conv(bc_pre, p["conv_BC"]))
    Bm, Cm = bc.split(N, dim=-1)
    dt, a = _gates(p, xw)
    xh = xi.reshape(B, S, H, P)
    b = Bm[:, :, None, :] * dt[..., None]
    c = Cm[:, :, None, :].expand(B, S, H, N)
    return z, xi_pre, bc_pre, xh, a, b, c


def mamba_apply(p: Mapping, xw: torch.Tensor, cfg, impl: Optional[str] = None,
                return_state: bool = False):
    """xw: (B, S, D) normed -> (B, S, D) [, decode cache]. The cache holds
    the last K-1 pre-conv rows of x and B/C (``S - (K-1)`` may be negative
    for S < K-1: the slice then keeps fewer rows, as the reference's does)
    and the scan's final state."""
    B, S, D = xw.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xi_pre, bc_pre, xh, a, b, c = ssd_inputs(p, xw, cfg)
    y, h_fin = ops.ssd(xh, a, b, c, impl=impl)
    y = y + p["D_skip"][None, None, :, None] * xh
    y = y.reshape(B, S, H * P)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z)
    out = constrain_act(project_out(y.to(xw.dtype), p["o"]).to(xw.dtype),
                        ("batch", "seq", None))
    if return_state:
        K = cfg.conv_kernel
        return out, {"conv_x": coll.seq_tail(xi_pre, K - 1),
                     "conv_BC": coll.seq_tail(bc_pre, K - 1), "h": h_fin}
    return out


def mamba_cache_init(cfg, batch: int, dtype, device) -> Tree:
    """Per-layer decode cache: conv tails in ``dtype``, the state in f32."""
    K = cfg.conv_kernel
    return {
        "conv_x": torch.zeros((batch, K - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_BC": torch.zeros((batch, K - 1, 2 * cfg.ssm_state),
                               dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                          cfg.ssm_head_dim), dtype=torch.float32,
                         device=device),
    }


def _conv_step(tail: torch.Tensor, new: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """One causal-conv output from the tail and the new row; shifts the
    tail in place (the new tail is built first: the shift overlaps)."""
    full = torch.cat([tail, new[:, None, :].to(tail.dtype)], dim=1)
    out = (full.float() * w[None].float()).sum(dim=1)
    tail.copy_(full[:, 1:])
    return out.to(new.dtype)


def mamba_decode(p: Mapping, xw: torch.Tensor, cache: Mapping,
                 cfg) -> torch.Tensor:
    """One-token step. xw: (B, D) normed input; ``cache`` (conv tails and
    h of this layer) is updated in place. The tails must already hold
    the promotion of their dtype and xw's (``lm.decode_step`` sees to it),
    as the reference's concatenation promotes them. Returns (B, D)."""
    B, _ = xw.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z = project_in(xw, p["z"])
    xi_new = project_in(xw, p["x"])
    bc_new = torch.cat([project_in(xw, p["B"]), project_in(xw, p["C"])],
                       dim=-1)
    xi = F.silu(_conv_step(cache["conv_x"], xi_new, p["conv_x"]))
    bc = F.silu(_conv_step(cache["conv_BC"], bc_new, p["conv_BC"]))
    Bm, Cm = bc.split(N, dim=-1)
    dt, a = _gates(p, xw)
    xh = xi.reshape(B, H, P).float()
    b = Bm[:, None, :].float() * dt[..., None]
    h = cache["h"]
    h.copy_(a[..., None, None] * h + b[..., :, None] * xh[..., None, :])
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h)
    y = y + p["D_skip"][None, :, None] * xh
    y = y.reshape(B, H * P).to(xw.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z)
    return project_out(y, p["o"])
