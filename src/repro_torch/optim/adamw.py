"""AdamW with optional bf16 moment states and global-norm clipping, as the
reference's ``optim/adamw.py``.

Parameters, gradients and the moments are flat mappings from a parameter's
name (``LM.named_parameters()``) to its tensor. Where the reference returns
new trees, ``adamw_update`` writes the parameters and moments in place: at
full width a second copy of each would cost as much device memory as the
first, and the step owns them. On DTensor parameters (a partitioned
step) the moments are placed as their parameters, the update runs on each
rank's blocks, and the clipping norm is the global one: the sum of
squares of a sharded gradient is partial over its mesh axes and is
reduced before the square root.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamWState:
    mu: Tree
    nu: Tree
    count: torch.Tensor          # int32 scalar


def _zeros(p: torch.Tensor, dtype) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def adamw_init(params: Mapping[str, torch.Tensor],
               state_dtype=torch.float32) -> AdamWState:
    zeros = lambda p: _zeros(p, state_dtype)
    dev = next(iter(params.values())).device
    return AdamWState(mu={k: zeros(p) for k, p in params.items()},
                      nu={k: zeros(p) for k, p in params.items()},
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0
                 ) -> Tuple[Mapping[str, torch.Tensor], AdamWState,
                            Dict[str, torch.Tensor]]:
    """One AdamW step on clipped gradients, parameters and moments updated
    in place (leaf by leaf, so the clipped gradients never exist all at
    once). Returns (params, state, {"grad_norm"})."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_grad_norm)
    count = state.count + 1
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=cf.device), cf)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for k, p in params.items():
        g = grads[k]
        m, v = state.mu[k], state.nu[k]
        gf = (g.float() * scale).to(g.dtype).float()
        m2 = b1 * m.float() + (1 - b1) * gf
        v2 = b2 * v.float() + (1 - b2) * gf * gf
        step = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
        m.copy_(m2.to(m.dtype))
        v.copy_(v2.to(v.dtype))
    state.count = count
    return params, state, {"grad_norm": gn}
