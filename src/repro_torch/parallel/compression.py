"""Gradient compression for a cross-node all-reduce: int8 quantization with
error feedback, as the reference's ``parallel/compression.py``.

Quantizing gradients to int8 with a per-tensor scale cuts the all-reduce's
bytes 4x against f32 (2x against bf16); the residual (quantization error)
is fed back into the next step's gradient, so the scheme is unbiased in the
long run (error-feedback SGD compresses safely).

Trees are flat ``{name: tensor}`` mappings. ``psum_compressed`` reduces
over a ``torch.distributed`` process group; with none, or a group of one
rank, it is compress then dequantize. No caller in the port uses the module
yet: it is the counterpart of the reference's.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, f32 scale): scale = max|x| / 127 (at least 1e-12),
    payload = round(x / scale) clipped to [-127, 127], half to even."""
    scale = x.abs().max().float() / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: Mapping[str, torch.Tensor],
                  residual: Mapping[str, torch.Tensor]
                  ) -> Tuple[Tree, Tree, Tree]:
    """Returns (quantized tree, scales tree, new residual tree)."""
    q, s, res = {}, {}, {}
    for k, g in grads.items():
        gf = g.float() + residual[k]
        q[k], s[k] = quantize_int8(gf)
        res[k] = gf - dequantize_int8(q[k], s[k])
    return q, s, res


def zero_residual(params: Mapping[str, torch.Tensor]) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def psum_compressed(grads: Mapping[str, torch.Tensor],
                    residual: Mapping[str, torch.Tensor],
                    group: Optional[object] = None) -> Tuple[Tree, Tree]:
    """int8 all-reduce over ``group`` with error feedback: the payloads are
    summed in int32 (``all_reduce`` SUM) and rescaled by the largest
    participating scale (``all_reduce`` MAX). Returns (summed f32 tree, new
    residual tree)."""
    import torch.distributed as dist
    q, s, res = compress_tree(grads, residual)
    alone = (group is None and not dist.is_initialized()) or \
        dist.get_world_size(group) == 1
    summed = {}
    for k in q:
        tot = q[k].to(torch.int32)
        smax = s[k].clone()
        if not alone:
            dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=group)
            dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        summed[k] = tot.float() * smax
    return summed, res
