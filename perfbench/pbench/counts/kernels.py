"""Operations and bytes of the program's hand-written kernels, frozen here
so that a change to the program cannot move the yardstick.

FLOPs are what the inputs need: causal attention takes the pairs on and
below the diagonal, two products of 2·D flops a pair forward (QKᵀ, PV) and
four backward (dP, dV, dS·K, dSᵀ·Q; the recompute of QKᵀ is the
algorithm's, not counted). The SSD's recurrence from a zero state is
5·N·P flops a step and head forward (a·h, b ⊗ x, c·h) and 11 backward (3
to carry dh, 2 each for dx, db, dc, da; recomputing h is not counted).
Bytes are each input read once and each output written once, at their
item sizes, with f32 decays, states and log-sum-exps.
"""
from __future__ import annotations

from typing import Tuple


def causal_pairs(sq: int, sk: int) -> int:
    """Query-key pairs with key <= query, the queries at the last sq of sk
    positions."""
    off = sk - sq
    return sq * (off + 1) + sq * (sq - 1) // 2


def attention_fwd(B: int, S: int, H: int, Hkv: int, D: int,
                  item: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of causal attention's forward: q, k, v read; out and
    lse (B, H, S) written."""
    flops = 4 * D * B * H * causal_pairs(S, S)
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * item + B * H * S * 4
    return flops, nbytes


def attention_bwd(B: int, S: int, H: int, Hkv: int, D: int,
                  item: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of its backward: q, k, v, out, dout and lse read; dq,
    dk, dv written."""
    flops = 8 * D * B * H * causal_pairs(S, S)
    nbytes = (4 * B * S * H * D + 4 * B * S * Hkv * D) * item + B * H * S * 4
    return flops, nbytes


def ssd_fwd(B: int, S: int, H: int, P: int, N: int,
            item: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of the SSD forward: x, a, b and c (one (B, S, N)
    tensor shared by the heads) read; y and h_final written."""
    flops = 5 * B * S * H * N * P
    nbytes = ((2 * B * S * H * P + B * S * H * N + B * S * N) * item
              + B * S * H * 4 + B * H * N * P * 4)
    return flops, nbytes


def ssd_bwd(B: int, S: int, H: int, P: int, N: int,
            item: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of its backward: x, a, b, c and dy read; dx, da, db
    and dc (per head, as the function returns it) written."""
    flops = 11 * B * S * H * N * P
    nbytes = ((3 * B * S * H * P + 3 * B * S * H * N + B * S * N) * item
              + 2 * B * S * H * 4)
    return flops, nbytes
