"""Seeded initial weights, made by the benchmark from the parameters'
names and shapes, so that the program and the reference get the same
tensors, in f32, the type both configurations train in.

Every normally drawn leaf is a view of one buffer filled by one
``torch.randn`` call on the device, scaled by 1/sqrt(fan-in): the input
features of a dense weight (its first dim; an attention output weight
(H, dh, D) takes H·dh), the embedding width for the table, the kernel
width for a conv. Norm scales and Mamba's ``D_skip`` start at 1.
Mamba-2's ``A_log`` and ``dt_bias`` are drawn as Mamba-2 initialises
them, from one ``torch.rand`` call after the normal draw: A = U[1, 16]
per head, ``A_log`` = log A; dt = exp(U[log 1e-3, log 1e-1]), at least
1e-4, and ``dt_bias`` its inverse softplus, dt + log(1 - exp(-dt)). So a
head's decay over a 128-step chunk ranges from about 0.9 to nearly 0, and
the state passed between chunks carries. A name no rule knows raises.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SEED_MASK = 2**64 - 1
ONES = ("scale", "D_skip")
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)
DT_FLOOR = 1e-4


def a_log(u: torch.Tensor) -> torch.Tensor:
    """log A for A uniform in ``A_RANGE``, from u uniform in [0, 1)."""
    lo, hi = A_RANGE
    return torch.log(lo + (hi - lo) * u)


def dt_bias(u: torch.Tensor) -> torch.Tensor:
    """The inverse softplus of dt, log-uniform in ``DT_RANGE`` (at least
    ``DT_FLOOR``), from u uniform in [0, 1)."""
    lo, hi = (math.log(v) for v in DT_RANGE)
    dt = torch.exp(lo + (hi - lo) * u).clamp(min=DT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))


UNIFORM = {"A_log": a_log, "dt_bias": dt_bias}


def rule(name: str, shape: Tuple[int, ...]):
    """("normal", scale), ("ones", None) or ("uniform", map)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ONES:
        return "ones", None
    if leaf in UNIFORM:
        return "uniform", UNIFORM[leaf]
    if name == "embed.table":
        return "normal", 1.0 / math.sqrt(shape[1])
    if leaf in ("conv_x", "conv_BC"):
        return "normal", 1.0 / math.sqrt(shape[0])
    if leaf == "w" and len(shape) == 3 and name.endswith(".o.w"):
        return "normal", 1.0 / math.sqrt(shape[0] * shape[1])
    if leaf == "w" and len(shape) in (2, 3):
        return "normal", 1.0 / math.sqrt(shape[0])
    raise KeyError(f"no initial rule for parameter {name!r} {shape}")


def make(leaves: List[Tuple[str, Tuple[int, ...]]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for ``leaves`` [(name, shape)], drawn from
    ``seed`` on ``device``."""
    dtype = torch.float32
    rules = [(n, s, rule(n, s)) for n, s in leaves]
    size = lambda k: sum(math.prod(s) for _, s, (kind, _) in rules
                         if kind == k)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    flat = torch.randn(size("normal"), generator=gen, dtype=dtype,
                       device=device)
    uni = torch.rand(size("uniform"), generator=gen, dtype=dtype,
                     device=device) if size("uniform") else None
    out, at, at_u = {}, 0, 0
    for name, shape, (kind, how) in rules:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = flat[at:at + n].view(shape).mul_(how)
            at += n
        elif kind == "uniform":
            out[name] = how(uni[at_u:at_u + n]).view(shape)
            at_u += n
        else:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
    return out
