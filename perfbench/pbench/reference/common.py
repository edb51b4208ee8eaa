"""What the families' references share: products in a stated precision,
norms, rotary embeddings, blocked causal attention with its gradient, the
chunked loss, and training steps with gradient accumulation and
AdamW.

Plain PyTorch in f32; nothing of the program is imported. Each layer runs
under ``torch.utils.checkpoint`` so that full-size steps fit the card,
and attention and the loss are computed in blocks of rows.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tree = Dict[str, torch.Tensor]


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32's 10-bit mantissa (nearest, ties away), in f32."""
    i = t.detach().float().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach()


class Products:
    """Matrix products in ``precision``: "f32" (TF32 off) or "tf32". On the
    card TF32 is the card's own (``matmul_precision``); on the CPU its
    operands are rounded to TF32 (forward only outside attention)."""

    def __init__(self, precision: str, device: torch.device):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.emulate = precision == "tf32" and device.type != "cuda"

    def _r(self, t: torch.Tensor) -> torch.Tensor:
        return to_tf32(t) if self.emulate else t

    def ein(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self._r(a), self._r(b))

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._r(a) @ self._r(b)


@contextlib.contextmanager
def matmul_precision(precision: str):
    """The card's f32 products as ``precision`` asks (TF32 on for "tf32",
    off for "f32"), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def layernorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Non-parametric LayerNorm (OLMo): no scale, no bias."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at positions 0..S-1, the two
    halves of each head rotated as one pair each."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class BlockedAttention(torch.autograd.Function):
    """Causal softmax attention of q, k, v (B, S, H, D), scale D^-1/2,
    over blocks of ``block`` queries (each against the keys up to its
    last), keeping each row's log-sum-exp; the backward recomputes each
    block's probabilities from it."""

    @staticmethod
    def forward(ctx, q, k, v, block: int, prod: Products):
        B, S, H, D = q.shape
        scale = D ** -0.5
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out = torch.empty_like(qt)
        lse = torch.empty((B, H, S), dtype=q.dtype, device=q.device)
        for q0 in range(0, S, block):
            q1 = min(S, q0 + block)
            s = _scores(prod, qt, kt, q0, q1, scale)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            out[:, :, q0:q1] = prod.mm(p, vt[:, :, :q1]) / l
            lse[:, :, q0:q1] = (m + torch.log(l))[..., 0]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (block, prod)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        block, prod = ctx.args
        B, S, H, D = q.shape
        scale = D ** -0.5
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        do = dout.transpose(1, 2)
        delta = (do * out).sum(-1)
        dq = torch.zeros_like(qt)
        dk = torch.zeros_like(kt)
        dv = torch.zeros_like(vt)
        for q0 in range(0, S, block):
            q1 = min(S, q0 + block)
            p = torch.exp(_scores(prod, qt, kt, q0, q1, scale)
                          - lse[:, :, q0:q1, None])
            dob = do[:, :, q0:q1]
            dv[:, :, :q1] += prod.mm(p.transpose(-1, -2), dob)
            dp = prod.mm(dob, vt[:, :, :q1].transpose(-1, -2))
            ds = p * (dp - delta[:, :, q0:q1, None]) * scale
            dq[:, :, q0:q1] = prod.mm(ds, kt[:, :, :q1])
            dk[:, :, :q1] += prod.mm(ds.transpose(-1, -2), qt[:, :, q0:q1])
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None)


def _scores(prod: Products, qt, kt, q0: int, q1: int, scale: float):
    """Scaled logits of queries [q0, q1) against keys [0, q1), -inf above
    the diagonal: (B, H, q1 - q0, q1)."""
    s = prod.mm(qt[:, :, q0:q1], kt[:, :, :q1].transpose(-1, -2)) * scale
    qpos = torch.arange(q0, q1, device=s.device)[:, None]
    kpos = torch.arange(q1, device=s.device)[None, :]
    return s.masked_fill(kpos > qpos, float("-inf"))


def attention(q, k, v, prod: Products, block: int = 1024):
    return BlockedAttention.apply(q, k, v, block, prod)


def _ce_chunk(x: torch.Tensor, table: torch.Tensor, tgt: torch.Tensor,
              prod: Products) -> torch.Tensor:
    lg = prod.ein("bcd,vd->bcv", x, table)
    return (torch.logsumexp(lg, -1)
            - lg.gather(-1, tgt[..., None])[..., 0]).sum()


def chunked_ce(x: torch.Tensor, table: torch.Tensor, tokens: torch.Tensor,
               chunk: int, prod: Products) -> torch.Tensor:
    """Mean next-token cross-entropy of final states x (B, S, D) against
    the tied table (all of its rows, padding included, in the log-sum-exp),
    over the whole ``chunk``s of the S - 1 predictions of each row (the
    rest are not scored), each chunk's logits made and dropped in turn."""
    B, S, _ = x.shape
    xs, tgt = x[:, :S - 1], tokens[:, 1:].long()
    c = min(chunk, S - 1)
    n = (S - 1) // c
    total = x.new_zeros(())
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_ce_chunk, xs[:, sl], table, tgt[:, sl],
                                   prod, use_reentrant=False)
    return total / (B * n * c)


def run_layers(layer: Callable, n: int, x: torch.Tensor) -> torch.Tensor:
    """``layer(i, x)`` for i in 0..n-1, each under checkpoint."""
    for i in range(n):
        x = checkpoint(layer, i, x, use_reentrant=False)
    return x


def lr_at(schedule: Dict, step: int) -> float:
    """The cosine schedule with linear warm-up, at ``step``."""
    base, warm, total = (schedule["base_lr"], schedule["warmup"],
                         schedule["total_steps"])
    if step < warm:
        return base * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.5 * base * (1.0 + math.cos(math.pi * prog))


def train_steps(loss_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
                params: Tree, batches: List[torch.Tensor], accum: int,
                lrs: List[float], adamw: Dict, on_step: Callable) -> Tree:
    """Steps of AdamW over ``batches`` (rows, S) each, the rows split into
    ``accum`` microbatches in order, f32 gradients summed and divided by
    ``accum``, clipped to a global norm of ``adamw["max_grad_norm"]``.
    ``params`` is updated in place; after step k, ``on_step(k, loss, grad
    norm before clipping, first moments)``."""
    b1, b2, eps, wd = (adamw["b1"], adamw["b2"], adamw["eps"],
                       adamw["weight_decay"])
    names = list(params)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    for k, tokens in enumerate(batches):
        g_sum = {n: torch.zeros_like(p) for n, p in params.items()}
        losses = []
        for mb in tokens.reshape((accum, -1) + tokens.shape[1:]):
            leaves = {n: params[n].detach().requires_grad_(True)
                      for n in names}
            loss = loss_fn(leaves, mb)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        allow_unused=True)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    if g is not None:
                        g_sum[n] += g
            losses.append(loss.detach())
            del loss, grads, leaves
        with torch.no_grad():
            for g in g_sum.values():
                g /= accum
            gn = torch.sqrt(sum(torch.sum(g * g) for g in g_sum.values()))
            scale = torch.clamp(adamw["max_grad_norm"]
                                / torch.clamp(gn, min=1e-9), max=1.0)
            t = k + 1
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for n in names:
                g = g_sum.pop(n) * scale
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g * g)
                upd = (m[n] / c1) / (torch.sqrt(v[n] / c2) + eps) \
                    + wd * params[n]
                params[n].sub_(lrs[k] * upd)
            on_step(k, float(torch.stack(losses).mean()), float(gn), m)
    return params


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), table)
