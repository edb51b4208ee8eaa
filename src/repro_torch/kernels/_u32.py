"""uint32 arithmetic for the plain PyTorch versions.

PyTorch keeps ``torch.uint32`` as a storage type: it has ``*``, ``^`` and
``&`` but no ``+``, ``<<``, ``>>`` or ``index_put``. The public API keeps
uint32 tensors (so ``.numpy()`` compares directly with the JAX package);
the plain versions widen to int64 holding values in [0, 2^32), do the
wraparound arithmetic there with ``& MASK``, and narrow back. Signed int32
would break the logical right shift.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def widen(t: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 tensor of the same values."""
    if t.dtype != torch.uint32:
        raise TypeError(f"expected uint32, got {t.dtype}")
    return t.view(torch.int32).to(torch.int64) & MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 tensor with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32).view(torch.uint32)


def mul(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and a uint32 constant
    ``b``, split in 16-bit halves so no int64 product overflows."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK


def rotl(x: torch.Tensor, k: int) -> torch.Tensor:
    return ((x << k) | (x >> (32 - k))) & MASK
