"""Mamba-2 SSD (state-space duality) chunked scan.

The recurrence h_t = a_t h_{t-1} + b_t ⊗ x_t, y_t = c_t · h_t over x
(B, S, H, P), decays a (B, S, H) in (0, 1], b and c (B, S, H, N), from a
zero state; it returns y (B, S, H, P) in x's dtype and the final state
h (B, H, N, P) in f32. Within a chunk of T steps, with cl = cumsum(log a),

    Y = (C Bᵀ ⊙ L) X + diag(exp(cl)) C h,   L[t, s] = exp(cl_t - cl_s), s <= t
    h' = exp(cl_{T-1}) h + (B ⊙ exp(cl_{T-1} - cl))ᵀ X

and the (N, P) state is carried from chunk to chunk in order.

L is zero above the diagonal, and the exponent is taken only on and below
it. Above it, cl_t - cl_s is a chunk's summed -log a: with Mamba-2's decays
that passes f32's exp overflow (~88.7) within a 128-step chunk, and
exp(inf) times a zero mask is NaN. The reference's blocked path and Pallas
body take the exponent everywhere and mask afterwards, so the blocked path
yields NaN there; ``ssd_ref`` and the Pallas kernel in interpret mode stay
finite, and this module computes what they compute.

``ssd_scan_cuda`` launches the hand-written kernel (``csrc/ssd_scan.cu``);
``ssd_scan_torch`` is the plain PyTorch version of the same chunked
algorithm, the CPU path and the kernel's oracle on the card.
``ops.ssd`` picks between them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128       # T: chunk rows a block stages in shared memory
MAX_STATE = 128       # N
MAX_HEAD_DIM = 64     # P
DTYPES = (torch.float32, torch.bfloat16)


def _chunk(S: int, chunk: int) -> int:
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of the chunk "
                         f"{chunk}")
    return chunk


def ssd_scan_torch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the chunked algorithm of the reference's blocked path
    (``ops._ssd_blocked``) with the decay masked before the exponent."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    T = _chunk(S, chunk)
    if not bool((a > 0).all()):
        raise ValueError("ssd_scan: the decays a must be > 0 (log a is taken)")
    la = torch.log(a.float())
    idx = torch.arange(T, device=x.device)
    above = (idx[None, :] > idx[:, None])[None, :, :, None]   # (1, t, s, 1)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S, T):
        xc = x[:, s0:s0 + T].float()                     # (B, T, H, P)
        bc = b[:, s0:s0 + T].float()                     # (B, T, H, N)
        cc = c[:, s0:s0 + T].float()
        cl = torch.cumsum(la[:, s0:s0 + T], dim=1)       # (B, T, H)
        diff = cl[:, :, None, :] - cl[:, None, :, :]     # (B, t, s, H)
        decay = torch.exp(diff.masked_fill(above, float("-inf")))
        cb = torch.einsum("bthn,bshn->btsh", cc, bc)
        y = torch.einsum("btsh,bshp->bthp", cb * decay, xc)
        y = y + torch.exp(cl)[..., None] * torch.einsum("bthn,bhnp->bthp",
                                                        cc, h)
        w = torch.exp(cl[:, -1:] - cl)                   # (B, T, H)
        h = torch.exp(cl[:, -1])[..., None, None] * h + torch.einsum(
            "bthn,bthp->bhnp", bc * w[..., None], xc)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. x, a and b contiguous on one CUDA device; c
    may be any strided view whose last dimension is contiguous (the mixer
    passes one (B, S, N) tensor broadcast over H, stride 0, not a copy).
    The C launcher runs the chunked form's three steps (chunk states, state
    passing, chunk scan) on scratch allocated here; it counts as one
    launch of ``ssd_scan``.
    The decays are not checked for a > 0 here: that would synchronize the
    host on every layer."""
    name = "ssd_scan"
    dev = _build.require_cuda(name, x, a, b)
    if c.device != dev or c.stride(-1) != 1:
        raise ValueError(f"{name}: c must be on {dev} with a contiguous "
                         f"last dimension")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"{name}: want x (B, S, H, P), a (B, S, H), b and c "
                         f"(B, S, H, N), got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if a.shape != (B, S, H) or b.shape[:3] != (B, S, H):
        raise ValueError(f"{name}: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    for what, t in (("x", x), ("b", b), ("c", c)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    _build.require_dtype(name, "a", a, torch.float32)
    T = _chunk(S, chunk)
    if T > MAX_CHUNK or N > MAX_STATE or P > MAX_HEAD_DIM:
        raise ValueError(f"{name}: chunk {T}, state {N}, head dim {P}; the "
                         f"kernel takes at most {MAX_CHUNK}, {MAX_STATE}, "
                         f"{MAX_HEAD_DIM}")
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    if B * H == 0:
        return y, h
    # scratch of the chunked form: each chunk's state, then (in place) the
    # state entering it; and cl = cumsum(log a) within each chunk
    states = torch.empty((B, H, S // T, N, P), dtype=torch.float32,
                         device=dev)
    cl = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    _build.launch(name, dev, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), y.data_ptr(), h.data_ptr(), states.data_ptr(),
                  cl.data_ptr(), B, S, H, P, N, T, c.stride(0), c.stride(1),
                  c.stride(2),
                  int(x.dtype == torch.bfloat16),
                  int(b.dtype == torch.bfloat16),
                  int(c.dtype == torch.bfloat16))
    return y, h


def work(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor
         ) -> Tuple[int, int]:
    """(flops, bytes) that the function needs, for the bound. Flops: the
    recurrence from a zero state, 5·N·P per step and head (a·h, the
    b ⊗ x update and c · h). The chunked form's products (C Bᵀ and its
    product with X over a chunk's triangle, C h and the state update per
    chunk) are the algorithm's cost, not the function's, and are not
    counted. Bytes: x, b and y once at their item sizes, a in f32, c once
    per distinct head (once in all when it is broadcast over H, stride
    0), h_final in f32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    flops = 5 * B * S * H * N * P
    c_heads = 1 if c.stride(2) == 0 else H
    nbytes = (B * S * H * P * 2 * x.element_size() + B * S * H * 4
              + B * S * H * N * b.element_size()
              + B * S * c_heads * N * c.element_size() + B * H * N * P * 4)
    return flops, nbytes
