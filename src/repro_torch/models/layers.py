"""Shared model layers: initializers, norms, RoPE, MLP, embedding.

Plain functions on tensors, as in the JAX package's ``models/layers.py``.
Parameters are dictionaries keyed as the reference's trees (``{"w", "b"}``
for a dense layer, ``{"scale"}`` for RMSNorm, ``{"gate", "up", "down"}`` for
the MLP), so the functions take a plain ``dict`` as well as the
``ParamTree`` modules the model holds. The init functions
draw the reference's distributions from an explicit ``torch.Generator``;
they build plain dictionaries of tensors, which ``to_module`` turns into
parameters. Parameters are built frozen (``requires_grad=False``), so
serving records no autograd graph; training switches them on with
``module.requires_grad_(True)``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.sharding import (at_use, constrain_act, is_dtensor,
                                           local_product)

Tree = Dict


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, bias: bool = False, scale: Optional[float] = None
               ) -> Tree:
    s = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    p = {"w": _normal(gen, (in_dim, out_dim), s, dtype, device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def weight(p: Mapping) -> torch.Tensor:
    """A dense layer's weight where a product uses it
    (``sharding.at_use``: gathered over the batch's mesh axes in a
    partitioned step, else ``p["w"]`` itself)."""
    return at_use(p["w"])


def project_in(x: torch.Tensor, p: Mapping) -> torch.Tensor:
    """``x @ w`` for a weight whose output features the model axis may
    split (column parallel; ``sharding.local_product`` on DTensors)."""
    w = weight(p)
    if not is_dtensor(w):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    return local_product(torch.matmul, x, [w], Replicate(),
                         Shard(x.dim() - 1), Partial())


def project_out(y: torch.Tensor, p: Mapping) -> torch.Tensor:
    """``y @ w`` for a weight whose input features the model axis may
    split, as y's are (row parallel: each rank's product a partial
    sum)."""
    w = weight(p)
    if not is_dtensor(w):
        return y @ w
    from torch.distributed.tensor import Partial, Shard
    return local_product(torch.matmul, y, [w], Shard(y.dim() - 1),
                         Partial(), Shard(y.dim() - 1))


def dense(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    y = x @ weight(p)
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(dim: int, dtype, device) -> Tree:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p: Optional[Mapping], x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if p is not None:
        y = y * p["scale"].float()
    return y.to(x.dtype)


def layernorm_nonparam(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def make_norm(cfg):
    """(init(dtype, device) -> params, apply(params, x)) for the arch's norm:
    parametric RMSNorm, or OLMo's non-parametric LayerNorm."""
    if cfg.nonparam_ln:
        return (lambda dtype, device: {}), (
            lambda p, x: layernorm_nonparam(x, cfg.norm_eps))
    return (lambda dtype, device: rmsnorm_init(cfg.d_model, dtype, device)), (
        lambda p, x: rmsnorm(p, x, cfg.norm_eps))


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S). f32 math, cast back. A
    DTensor x is rotated on each rank's block, in its own layout."""
    if is_dtensor(x):
        return _rope_partitioned(x, positions, theta)
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions[..., None].float() * freqs                # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope_partitioned(x: torch.Tensor, positions: torch.Tensor,
                      theta: float) -> torch.Tensor:
    """``apply_rope`` on each rank's block of x, positions split as x's
    leading dims are (a plain tensor of positions is whole on every
    rank): the output keeps x's placements, where DTensor's rule for the
    products with the replicated cos and sin may choose another."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    if not is_dtensor(positions):
        positions = DTensor.from_local(positions, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
    pos_pl = tuple(q if isinstance(q, Shard) and q.dim < positions.dim()
                   else Replicate() for q in x.placements)
    return local_map(lambda x, p: apply_rope(x, p, theta),
                     out_placements=list(x.placements),
                     in_placements=(tuple(x.placements), pos_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, positions)


# -- SwiGLU MLP ----------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device) -> Tree:
    return {"gate": dense_init(gen, d_model, d_ff, dtype, device),
            "up": dense_init(gen, d_model, d_ff, dtype, device),
            "down": dense_init(gen, d_ff, d_model, dtype, device)}


def mlp(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    if is_dtensor(x):
        return _mlp_partitioned(p, x)
    h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    h = constrain_act(h, ("batch", "seq", "ff"))
    return dense(p["down"], h)


def _mlp_partitioned(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    """The MLP on each rank's blocks (``sharding.local_product``): x whole
    over the axes that split ff, each rank's output a partial sum over
    them, and so is its input's gradient."""
    from torch.distributed.tensor import Partial, Replicate
    return local_product(lambda x, g, u, d: (F.silu(x @ g) * (x @ u)) @ d,
                         x, [weight(p[k]) for k in ("gate", "up", "down")],
                         Replicate(), Partial(), Partial())


# -- Embedding -------------------------------------------------------------------

def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Embedding tables are padded to a multiple of 256 rows, as in the
    reference; pad logits are masked to NEG_INF by ``lm.vocab_bias``."""
    return ((vocab + multiple - 1) // multiple) * multiple


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               device) -> Tree:
    vp = pad_vocab(vocab)
    return {"table": _normal(gen, (vp, d_model), 1.0 / math.sqrt(d_model),
                             dtype, device)}


def embed(p: Mapping, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows of ``tokens``; a DTensor table takes
    ``_embed_partitioned``."""
    if is_dtensor(p["table"]):
        return _embed_partitioned(p["table"], tokens)
    return p["table"][tokens]


def _embed_partitioned(table: torch.Tensor, tokens: torch.Tensor
                       ) -> torch.Tensor:
    """Vocab-parallel lookup: each rank holds a block of the table's rows
    and the tokens whole over the vocab's mesh axes; it looks up the
    tokens that fall in its block, zeros the rest, and the output is the
    sum over those axes (a ``Partial`` placement, reduced where the next
    pin asks). Every term but one of that sum is an exact zero. The
    table's gradient is partial over the other axes, whose ranks hold
    other tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    vocab = [i for i, q in enumerate(table.placements) if q == Shard(0)]
    tok_pl = [Replicate() if i in vocab else q
              for i, q in enumerate(tokens.placements)]
    out_pl = [Partial() if i in vocab else
              (Shard(q.dim) if isinstance(q, Shard) else Replicate())
              for i, q in enumerate(tok_pl)]
    grad_pl = [Shard(0) if i in vocab else Partial()
               for i in range(mesh.ndim)]
    coord = mesh.get_coordinate()
    index = 0
    for i in vocab:
        index = index * mesh.size(i) + coord[i]

    def lookup(tok, tab):
        rows = tab.shape[0]
        local = tok.long() - index * rows
        hit = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(hit, local, 0), tab)
        return out * hit[..., None].to(out.dtype)

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(tuple(tok_pl), tuple(table.placements)),
                     in_grad_placements=(tuple(tok_pl), tuple(grad_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(
        tokens, table)


# -- Parameter trees as modules ------------------------------------------------------

class ParamTree(nn.Module):
    """A parameter tree as a module: tensors become parameters and sub-dicts
    sub-modules, under their own keys, and the module is indexed (``p[k]``,
    ``k in p``) as the dict was. A mamba mixer's tree mixes both
    (``{"z": {"w"}, ..., "A_log": T}``)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))
            else:
                self.add_module(k, ParamTree(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def to_module(tree: Mapping) -> nn.Module:
    """A nested dict of tensors as nested ``ParamTree`` modules. Keys and
    nesting are kept, so the functions above index the module as they
    index the dict."""
    return ParamTree(tree)
