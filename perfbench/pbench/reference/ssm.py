"""Plain reference of a Mamba-2 training loss (mamba2-370m).

Pre-norm layers: RMSNorm, the Mamba-2 mixer and a residual; a final
RMSNorm and the chunked loss against the tied table. The mixer: z = x Wz
(the gate), x Wx and (x WB, x WC) through a causal depthwise conv of
width K and SiLU, dt = softplus(x Wdt + dt_bias), a = exp(-exp(A_log)
dt); the SSD h_t = a_t h_{t-1} + (B_t dt_t) ⊗ x_t, y_t = C_t · h_t +
D x_t per head, from a zero state; then RMSNorm(y) · SiLU(z) and the out
projection. Parameters are named as the program names them
(``segments.0.<layer>.mamba.x.w``, ...).

The SSD is computed as the chunked dual form, in blocks of ``ssd_chunk``
steps: within a chunk the (T, T) decay matrix exp(cl_t - cl_s), s <= t,
its exponent masked before the exponential; the states entering each
chunk from every earlier chunk's state through the (chunks, chunks)
decay matrix, in one product.

Departures from Mamba-2 as published, which the program makes too:
separate projections and convs for x and (B, C), no conv bias, one
group, D at 1, RMSNorm before the gate (not of the gated product), the
table padded to a multiple of 256 rows with the padding in the loss's
log-sum-exp, whole 512-position chunks scored.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from pbench.reference import common

Tree = Dict[str, torch.Tensor]


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter."""
    D, Din, N = cfg["d_model"], cfg["d_inner"], cfg["ssm_state"]
    H, K = cfg["ssm_heads"], cfg["conv_kernel"]
    out = [("embed.table", (cfg["vocab_rows"], D))]
    for i in range(cfg["n_layers"]):
        p = f"segments.0.{i}."
        out += [(p + "norm1.scale", (D,)), (p + "mamba.z.w", (D, Din)),
                (p + "mamba.x.w", (D, Din)), (p + "mamba.B.w", (D, N)),
                (p + "mamba.C.w", (D, N)), (p + "mamba.dt.w", (D, H)),
                (p + "mamba.o.w", (Din, D)), (p + "mamba.norm.scale", (Din,)),
                (p + "mamba.conv_x", (K, Din)),
                (p + "mamba.conv_BC", (K, 2 * N)),
                (p + "mamba.A_log", (H,)), (p + "mamba.dt_bias", (H,)),
                (p + "mamba.D_skip", (H,))]
    return out + [("final_norm.scale", (D,))]


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of x (B, S, Ch) with w (K, Ch)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, :S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int, prod: common.Products) -> torch.Tensor:
    """y of the recurrence from a zero state. x (B, S, H, P), a (B, S, H)
    in (0, 1], b (B, S, H, N), c (B, S, N) shared by the heads."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    T = min(chunk, S)
    nc = S // T
    xr = x.reshape(B, nc, T, H, P)
    br = b.reshape(B, nc, T, H, N)
    cr = c.reshape(B, nc, T, N)
    cl = torch.cumsum(torch.log(a).reshape(B, nc, T, H), dim=2)
    idx = torch.arange(T, device=x.device)
    above = idx[None, :] > idx[:, None]                      # (t, s)
    diff = cl[:, :, :, None, :] - cl[:, :, None, :, :]       # (B, c, t, s, H)
    L = torch.exp(diff.masked_fill(above[None, None, :, :, None],
                                   float("-inf")))
    cb = prod.ein("bctn,bcshn->bctsh", cr, br)
    y = prod.ein("bctsh,bcshp->bcthp", cb * L, xr)
    last = cl[:, :, -1]                                      # (B, c, H)
    w = torch.exp(last[:, :, None] - cl)                     # (B, c, T, H)
    states = prod.ein("bcshn,bcshp->bchnp", br * w[..., None], xr)
    # the state entering chunk i: sum over j < i of the decay from the end
    # of chunk j to the start of chunk i times chunk j's state
    A = torch.cumsum(last, dim=1)                            # (B, c, H)
    ci = torch.arange(nc, device=x.device)
    before = ci[None, :] < ci[:, None]                       # (i, j): j < i
    dec = (A - last)[:, :, None, :] - A[:, None, :, :]       # (B, i, j, H)
    M = torch.exp(dec.masked_fill(~before[None, :, :, None], float("-inf")))
    h_in = prod.ein("bijh,bjhnp->bihnp", M, states)
    y = y + torch.exp(cl)[..., None] * prod.ein("bctn,bchnp->bcthp", cr,
                                                h_in)
    return y.reshape(B, S, H, P)


def loss(cfg: Dict, P: Tree, tokens: torch.Tensor,
         prod: common.Products) -> torch.Tensor:
    if not cfg["tie_embeddings"]:
        raise NotImplementedError("the ssm reference covers a tied table")
    eps = cfg["norm_eps"]
    H, Pd, N = cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["ssm_state"]

    def layer(i: int, x: torch.Tensor) -> torch.Tensor:
        w = lambda leaf: P[f"segments.0.{i}.{leaf}"]
        B, S, _ = x.shape
        h = common.rmsnorm(x, w("norm1.scale"), eps)
        z = prod.mm(h, w("mamba.z.w"))
        xi = F.silu(causal_conv(prod.mm(h, w("mamba.x.w")),
                                w("mamba.conv_x")))
        bc = torch.cat([prod.mm(h, w("mamba.B.w")),
                        prod.mm(h, w("mamba.C.w"))], dim=-1)
        bc = F.silu(causal_conv(bc, w("mamba.conv_BC")))
        Bm, Cm = bc.split(N, dim=-1)
        dt = F.softplus(prod.mm(h, w("mamba.dt.w")) + w("mamba.dt_bias"))
        a = torch.exp(-torch.exp(w("mamba.A_log")) * dt)
        xh = xi.reshape(B, S, H, Pd)
        y = ssd(xh, a, Bm[:, :, None, :] * dt[..., None], Cm,
                cfg["ssd_chunk"], prod)
        y = (y + w("mamba.D_skip")[:, None] * xh).reshape(B, S, H * Pd)
        y = common.rmsnorm(y, w("mamba.norm.scale"), eps) * F.silu(z)
        return x + prod.mm(y, w("mamba.o.w"))

    x = common.embed(P["embed.table"], tokens)
    x = common.run_layers(layer, cfg["n_layers"], x)
    x = common.rmsnorm(x, P["final_norm.scale"], eps)
    return common.chunked_ce(x, P["embed.table"], tokens, cfg["loss_chunk"],
                             prod)
