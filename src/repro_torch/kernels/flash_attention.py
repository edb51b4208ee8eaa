"""Blocked causal / sliding-window GQA attention, forward (prefill).

Flash attention computes softmax attention of q (B, Sq, Hq, D) over
k/v (B, Sk, Hkv, D), Hq a multiple of Hkv, with f32 math and the output in
q's dtype. Queries sit at the last Sq of the Sk positions
(``qpos = i + Sk - Sq``); ``causal`` keeps keys with ``kpos <= qpos`` and
``window`` keys with ``kpos > qpos - window``; a row with no valid key
outputs 0. ``flash_attention_cuda`` launches the hand-written kernel
(``csrc/flash_attention.cu``); ``flash_attention_torch`` is the plain
PyTorch version of the same online-softmax recurrence, the CPU path and
the kernel's oracle on the card. ``ops.attention`` picks between them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import hw
from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_Q = 64          # query rows per CUDA block
BLOCK_K = 64          # keys per CUDA tile
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def key_range(q0: int, q1: int, Sq: int, Sk: int, causal: bool,
              window: Optional[int]) -> Tuple[int, int]:
    """Keys [lo, hi) that queries [q0, q1) may attend to; tiles outside it
    are skipped (by the kernel and the plain version alike)."""
    off = Sk - Sq
    lo, hi = 0, Sk
    if causal:
        hi = min(Sk, q1 + off)
    if window is not None:
        lo = max(0, q0 + off - window + 1)
    return lo, max(lo, hi)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          block_k: int = 256) -> torch.Tensor:
    """Plain version: the online-softmax recurrence of the reference's
    blocked path (``ops._attention_blocked_fwd``) over key blocks of
    ``block_k``, probabilities multiplied by the mask as the Pallas kernel
    does. Any Sk (the last block may be short)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Sq, Hkv, G, D) * scale
    qpos = torch.arange(Sq, device=dev) + (Sk - Sq)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    lo, hi = key_range(0, Sq, Sq, Sk, causal, window)
    for k0 in range(lo - lo % block_k, hi, block_k):
        k1 = min(k0 + block_k, Sk)
        kb = k[:, k0:k1].float()
        vb = v[:, k0:k1].float()
        logits = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        mask = _mask(qpos, torch.arange(k0, k1, device=dev), causal, window)
        mb = mask[None, :, None, None, :]
        logits = torch.where(mb, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None]) * mb
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd",
                                                    p, vb)
        m = m_new
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe[..., None]).reshape(B, Sq, Hq, D).to(q.dtype)


def smem_bytes(head_dim: int) -> int:
    """Shared memory of one block: Q and K tiles (rows padded by 4 floats),
    the V tile and the probability tile, all f32."""
    D = head_dim
    return 4 * (BLOCK_Q * (D + 4) + BLOCK_K * (D + 4) + BLOCK_K * D
                + BLOCK_Q * (BLOCK_K + 1))


def check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Raise on any input the attention kernels do not take."""
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must start 16-byte aligned")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported; the kernel "
                         f"takes {HEAD_DIMS}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel; every tensor contiguous on one CUDA device."""
    name = "flash_attention"
    dev = _build.require_cuda(name, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B, Sq, Hq, D) and k, v "
                         f"(B, Sk, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    check_shapes(name, q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if smem_bytes(D) > hw.SMEM_PER_BLOCK_MAX:
        raise ValueError(f"{name}: head dim {D} needs {smem_bytes(D)} B of "
                         f"shared memory, more than a block can have")
    if max(B, Hq) > 65535:
        raise ValueError(f"{name}: B={B}, Hq={Hq} exceed the grid")
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if B * Sq == 0:
        return out
    _build.launch(name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(causal),
                  0 if window is None else int(window), scale,
                  int(q.dtype == torch.bfloat16),
                  int(k.dtype == torch.bfloat16),
                  int(v.dtype == torch.bfloat16))
    return out


def work(q_shape, k_shape, causal: bool, window: Optional[int]) -> int:
    """Query-key pairs inside the mask, summed over batch and heads: the
    unmasked band whose two products (QKᵀ and PV, 2·D flops each) a kernel
    must do."""
    B, Sq, Hq, _ = q_shape
    Sk = k_shape[1]
    pairs = 0
    for i in range(Sq):
        lo, hi = key_range(i, i + 1, Sq, Sk, causal, window)
        pairs += max(0, hi - lo)
    return B * Hq * pairs
