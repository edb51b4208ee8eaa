"""Single-token decode attention over a KV cache (flash-decoding).

Decode attention attends one query token per row, q (B, Hq, D), over
k/v (B, S, Hkv, D), keeping cache positions ``s < kv_len[b]``; f32 math,
output (B, Hq, D) in q's dtype. q and the cache may each be float32 or
bfloat16. ``decode_attention_cuda`` launches the hand-written split +
combine kernels (``csrc/decode_attention.cu``); ``decode_attention_torch``
is the plain PyTorch version of the Pallas kernel's online-softmax
recurrence over key blocks, the CPU path and the kernel's oracle on the
card. ``ops.decode_attention`` picks between them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import NEG_INF, check_shapes

TILE = 64             # keys per inner tile of the CUDA kernel
MAX_SPLITS = 32
THREADS = 256
MAX_OUT_PER_THREAD = 8


def decode_attention_torch(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: torch.Tensor, *,
                           scale: Optional[float] = None,
                           block_k: int = 512) -> torch.Tensor:
    """Plain version: the Pallas kernel's recurrence — running (max, sum,
    acc) per (b, kv head, g) over key blocks of ``block_k``, probabilities
    multiplied by the ``s < kv_len`` mask."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Hkv, G, D) * scale
    kv_len = kv_len.to(dev)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=dev)
    for k0 in range(0, S, block_k):
        k1 = min(k0 + block_k, S)
        kb = k[:, k0:k1].float()
        vb = v[:, k0:k1].float()
        valid = (torch.arange(k0, k1, device=dev)[None, :]
                 < kv_len[:, None])[:, None, None, :]          # (B,1,1,bk)
        logits = torch.einsum("bhgd,bshd->bhgs", qf, kb)
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None]) * valid
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgs,bshd->bhgd", p, vb)
        m = m_new
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe[..., None]).reshape(B, Hq, D).to(q.dtype)


def splits(S: int) -> Tuple[int, int]:
    """(number of splits, keys per split) of an S-deep cache: chunks of
    whole 64-key tiles, at most ``MAX_SPLITS`` of them."""
    tiles = -(-S // TILE)
    chunk = TILE * -(-tiles // MAX_SPLITS)
    return -(-S // chunk), chunk


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernels; every tensor contiguous on one CUDA
    device, kv_len int32."""
    name = "decode_attention"
    dev = _build.require_cuda(name, q, k, v, kv_len)
    _build.require_dtype(name, "kv_len", kv_len, torch.int32)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B, Hq, D) and k, v (B, S, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, D = q.shape
    _, S, Hkv, Dk = k.shape
    if (k.shape[0] != B or Dk != D or Hkv == 0 or Hq % Hkv
            or kv_len.shape != (B,)):
        raise ValueError(f"{name}: k/v {tuple(k.shape)}, kv_len "
                         f"{tuple(kv_len.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    check_shapes(name, q, k, v)
    G = Hq // Hkv
    if G * D > THREADS * MAX_OUT_PER_THREAD:
        raise ValueError(f"{name}: {G} query heads per KV head at D={D} "
                         f"exceed the kernel's {THREADS * MAX_OUT_PER_THREAD} "
                         f"outputs per block")
    if B * Hkv > 65535:
        raise ValueError(f"{name}: B*Hkv={B * Hkv} exceeds the grid")
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out.zero_()
    nsplit, chunk = splits(S)
    part_acc = torch.empty((B * Hq * nsplit * D,), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((B * Hq * nsplit * 2,), dtype=torch.float32,
                          device=dev)
    _build.launch(name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  kv_len.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                  part_ml.data_ptr(), B, S, Hq, Hkv, D, nsplit, chunk, scale,
                  int(q.dtype == torch.bfloat16),
                  int(k.dtype == torch.bfloat16),
                  int(v.dtype == torch.bfloat16))
    return out


def work(kv_len: torch.Tensor, S: int, Hq: int) -> int:
    """Query-head/key pairs inside the ``s < kv_len`` mask, summed over the
    batch: each costs 4·D flops (q·k and p·v)."""
    return int(kv_len.clamp(0, S).sum()) * Hq

