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

The kernel has two instances (``instance``). q, k and v all bf16 at head
dim 128, every bf16 config's pairing, go to the bf16 one: exact bf16
products on the tensor cores, 64-key tiles, K and V read as they are. Every
other pairing (f32 at any head dim, f32 q over bf16 k/v, bf16 at head dims
16, 64 and 256) goes to the f32 one: 3xTF32 products, 16-key tiles, bf16
K and V widened to f32 by the wrapper (exactly).

For training, both forwards can also return each row's log-sum-exp of its
scaled logits, ``lse`` (B, Hq, Sq) f32 (1e30 for a row with no valid key),
and the gradient is ``flash_attention_bwd_cuda`` (the hand-written kernels
of ``csrc/flash_attention_bwd.cu``) or ``flash_attention_bwd_torch``, the
plain port of the reference's ``ops._attention_blocked_bwd``.
"""
from __future__ import annotations

import functools
import heapq
from typing import Optional, Tuple

import torch

from repro_torch import hw
from repro_torch.kernels import _build

NEG_INF = -1e30
LSE_EMPTY = 1e30      # lse of a row with no valid key: exp(s - lse) == 0
BLOCK_ROWS = 128      # (query position, query head) rows per CUDA block
BLOCK_K = 16          # keys per CUDA tile of the f32 instance, double-buffered
BLOCK_K_BF16 = 64     # ... of the bf16 instance
BF16_HEAD_DIM = 128   # the bf16 instance's head dim
BF16_BLOCKS_PER_SM = 2   # its blocks an SM holds (128 registers, 96 KB)
HEAD_DIMS = (16, 64, 128, 256)   # every config's, and d_head 16 of reduced()
DTYPES = (torch.float32, torch.bfloat16)


def instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel instance that serves these inputs: "bf16" for q, k and v
    all bf16 at head dim 128, else "f32"."""
    bf16 = q.dtype == k.dtype == v.dtype == torch.bfloat16
    return "bf16" if bf16 and q.shape[-1] == BF16_HEAD_DIM else "f32"


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


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """f32 math for f32 and bf16 inputs; f64 inputs (finite-difference
    checks of the plain pair) stay f64."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          block_k: int = 256, return_lse: bool = False):
    """Plain version: the online-softmax recurrence of the reference's
    blocked path (``ops._attention_blocked_fwd``) over key blocks of
    ``block_k``, probabilities multiplied by the mask as the Pallas kernel
    does. Any Sk (the last block may be short). With ``return_lse``
    returns (out, lse (B, Hq, Sq) f32)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    f = _acc_dtype(q)
    qf = q.to(f).reshape(B, Sq, Hkv, G, D) * scale
    qpos = torch.arange(Sq, device=dev) + (Sk - Sq)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=f, device=dev)
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=f, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=f, device=dev)
    lo, hi = key_range(0, Sq, Sq, Sk, causal, window)
    for k0 in range(lo - lo % block_k, hi, block_k):
        k1 = min(k0 + block_k, Sk)
        kb = k[:, k0:k1].to(f)
        vb = v[:, k0:k1].to(f)
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
    out = (acc / safe[..., None]).reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0.0, m + torch.log(safe), LSE_EMPTY)
    return out, lse.reshape(B, Sq, Hq).transpose(1, 2).contiguous()


def flash_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None,
                              block_k: int = 256):
    """Plain version of the gradient: the reference's
    ``ops._attention_blocked_bwd`` over key blocks of ``block_k`` (any Sk).
    ``delta = rowsum(dO · O)``, p recomputed from ``lse`` (B, Hq, Sq),
    ``ds = p (dp - delta) scale``. Returns (dq, dk, dv) in the dtypes of
    q, k, v."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    f = _acc_dtype(q)
    qf = q.to(f).reshape(B, Sq, Hkv, G, D)
    do = dout.to(f).reshape(B, Sq, Hkv, G, D)
    delta = (do * out.to(f).reshape(B, Sq, Hkv, G, D)).sum(-1)
    lse5 = lse.transpose(1, 2).reshape(B, Sq, Hkv, G)
    qpos = torch.arange(Sq, device=dev) + (Sk - Sq)
    dq = torch.zeros((B, Sq, Hkv, G, D), dtype=f, device=dev)
    dk = torch.zeros((B, Sk, Hkv, D), dtype=f, device=dev)
    dv = torch.zeros((B, Sk, Hkv, D), dtype=f, device=dev)
    lo, hi = key_range(0, Sq, Sq, Sk, causal, window)
    for k0 in range(lo - lo % block_k, hi, block_k):
        k1 = min(k0 + block_k, Sk)
        kb = k[:, k0:k1].to(f)
        vb = v[:, k0:k1].to(f)
        logits = torch.einsum("bqhgd,bkhd->bqhgk", qf * scale, kb)
        mask = _mask(qpos, torch.arange(k0, k1, device=dev), causal, window)
        bias = torch.where(mask, 0.0, NEG_INF)[None, :, None, None, :]
        p = torch.exp(logits + bias - lse5[..., None])
        dv[:, k0:k1] = torch.einsum("bqhgk,bqhgd->bkhd", p, do)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", do, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bqhgk,bkhd->bqhgd", ds, kb)
        dk[:, k0:k1] = torch.einsum("bqhgk,bqhgd->bkhd", ds, qf)
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def smem_bytes(head_dim: int) -> int:
    """Shared memory of one block, all f32: the Q rows, two stages of a K
    tile and a V tile (V rows padded by 4 floats as they land), and the
    current tile's K lo and Vᵀ lo (229,888 B at D 256)."""
    D = head_dim
    return 4 * (BLOCK_ROWS * D + 2 * BLOCK_K * (2 * D + 4)
                + 2 * BLOCK_K * D)


def block_rows(Hq: int, Hkv: int) -> Tuple[int, int]:
    """(query positions, head groups) of the kernel's blocks: the G = Hq /
    Hkv query heads of a KV head fold into a block's BLOCK_ROWS rows, so a
    block holds BLOCK_ROWS // G positions (G <= BLOCK_ROWS), and a KV head
    needs ceil(G / BLOCK_ROWS) head groups."""
    G = Hq // Hkv
    Gb = min(G, BLOCK_ROWS)
    return BLOCK_ROWS // Gb, -(-G // Gb)


BLOCK_START_TILES = 2   # a block's Q load and first fetch, in key tiles


def _makespan(sizes, sms: int) -> int:
    """Time, in key tiles, of blocks of these sizes on ``sms`` SMs, each
    taking the next block when it is free, longest first; every block also
    pays BLOCK_START_TILES."""
    sizes = sorted((s + BLOCK_START_TILES for s in sizes), reverse=True)
    if len(sizes) <= sms:
        return sizes[0] if sizes else 0
    free = [0] * sms
    for s in sizes:
        heapq.heappush(free, heapq.heappop(free) + s)
    return max(free)


@functools.lru_cache(maxsize=256)
def key_split(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, causal: bool,
              window: Optional[int], sms: int,
              block_k: int = BLOCK_K) -> Tuple[int, int]:
    """(kmax, max_parts): the most key tiles (of ``block_k`` keys) one
    block walks, and the most blocks a query tile's key range is split
    over (then combined), with ``sms`` blocks running at once. The
    causal grid's query tiles see from 1 to Sk / block_k key tiles, and
    with as many blocks as SMs the longest sets the time. A query tile of
    more than kmax tiles is cut into ceil(tiles / kmax) near-equal ranges;
    kmax is the longest range, or a half, third or quarter of it, whichever
    gives the shortest makespan (``_makespan``; one more tile charged for
    the combine); nothing is split when that does not help."""
    PB, groups = block_rows(Hq, Hkv)
    tiles = []
    for p0 in range(0, Sq, PB):
        lo, hi = key_range(p0, min(p0 + PB, Sq), Sq, Sk, causal, window)
        tiles.append(-(-hi // block_k) - lo // block_k if hi > lo else 0)
    longest = max(tiles)
    copies = B * Hkv * groups
    best = (_makespan(tiles * copies, sms), max(longest, 1), 1)
    for k in (2, 3, 4):
        kmax = -(-longest // k)
        if kmax < 1 or kmax >= longest:
            continue
        sizes = []
        for t in tiles:
            parts = -(-t // kmax) if t > kmax else 1
            ln = -(-t // parts)
            sizes += [min(ln, t - j * ln) for j in range(parts)]
        span = _makespan(sizes * copies, sms) + 1
        if span < best[0]:
            best = (span, kmax, -(-longest // kmax))
    return best[1], best[2]


def split_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: Optional[int]) -> Tuple[int, int]:
    """``key_split`` as the wrapper takes it for these inputs: the tiles of
    their instance, and the blocks their card runs at once."""
    B, Sq, Hq, _ = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    bf16 = instance(q, k, v) == "bf16"
    sms = hw.device_spec(q.device.index or 0).sms
    return key_split(B, Sq, Sk, Hq, Hkv, causal, window,
                     sms * BF16_BLOCKS_PER_SM if bf16 else sms,
                     BLOCK_K_BF16 if bf16 else BLOCK_K)


def check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Raise on any input the attention kernels do not take."""
    real = not _build.traced(q)
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if real and t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must start 16-byte aligned")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported; the kernel "
                         f"takes {HEAD_DIMS}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the CUDA kernel's instance for these inputs (``instance``);
    every tensor contiguous on one CUDA device. Long causal key ranges are
    split over blocks (``key_split``) and a second kernel combines them,
    on scratch allocated here; the call counts as one launch of
    ``flash_attention``. With ``return_lse`` the kernel also writes lse and
    the call returns (out, lse (B, Hq, Sq) f32)."""
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
    bf16 = instance(q, k, v) == "bf16"
    if not bf16 and smem_bytes(D) > hw.SMEM_PER_BLOCK_MAX:
        raise ValueError(f"{name}: head dim {D} needs {smem_bytes(D)} B of "
                         f"shared memory, more than a block can have")
    if max(B, Hkv) > 65535:
        raise ValueError(f"{name}: B={B}, Hkv={Hkv} exceed the grid")
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if B * Sq == 0:
        return (out, lse) if return_lse else out
    kmax, parts = split_plan(q, k, v, causal, window)
    o_part = ml_part = None
    if parts > 1:     # scratch of the split query tiles, combined in-kernel
        o_part = torch.empty((parts, B, Sq, Hq, D), dtype=torch.float32,
                             device=dev)
        ml_part = torch.empty((parts, B, Sq, Hq, 2), dtype=torch.float32,
                              device=dev)
    # the f32 instance's row copies move bytes as they are: bf16 K/V are
    # widened here (exactly) and read as f32; the bf16 instance reads them
    # as they are
    kk, vv = (k, v) if bf16 else (k.float(), v.float())
    if _build.traced(q):
        _build.trace_launch(name, *cost(q, k, v, causal, window,
                                        return_lse))
        return (out, lse) if return_lse else out
    _build.launch(name, dev, q.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                  out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(causal),
                  0 if window is None else int(window), scale,
                  int(q.dtype == torch.bfloat16), int(bf16), kmax, parts,
                  o_part.data_ptr() if parts > 1 else None,
                  ml_part.data_ptr() if parts > 1 else None,
                  lse.data_ptr() if return_lse else None)
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None):
    """Launch the backward kernels (``csrc/flash_attention_bwd.cu``: delta,
    then dK/dV over key tiles, then dQ over query tiles, no atomics; 3xTF32
    on the tensor cores at head dims 16, 64 and 128, f32 FMAs at 256); every
    tensor on one CUDA device. The kernels take f32: bf16 inputs are
    widened here (exactly) and the gradients cast back to the inputs'
    dtypes. Counts as one launch of ``flash_attention_bwd``. Returns
    (dq, dk, dv)."""
    name = "flash_attention_bwd"
    _build.require_cuda(name, q, k, v, out, lse, dout)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B, Sq, Hq, D) and k, v "
                         f"(B, Sk, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: out and dout must be shaped as q")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be (B, Hq, Sq) float32, got "
                         f"{lse.dtype}{tuple(lse.shape)}")
    check_shapes(name, q, k, v)
    check_shapes(name, out, dout, dout)
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if max(B, Hkv) > 65535:
        raise ValueError(f"{name}: B={B}, Hkv={Hkv} exceed the grid")
    dev = q.device
    scale = float(scale) if scale is not None else D ** -0.5
    qf, kf, vf, of, dof = (t.float().contiguous()
                           for t in (q, k, v, out, dout))
    dq = torch.empty_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    if B * Sq == 0:
        return dq.to(q.dtype), dk.zero_().to(k.dtype), dv.zero_().to(v.dtype)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    if _build.traced(q):
        _build.trace_launch(name, *cost_bwd(q, k, lse, causal, window))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    _build.launch(name, dev, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                  of.data_ptr(), dof.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(causal),
                  0 if window is None else int(window), scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def work(q_shape, k_shape, causal: bool, window: Optional[int]) -> int:
    """Query-key pairs inside the mask, summed over batch and heads: the
    unmasked band whose two products (QKᵀ and PV, 2·D flops each) a
    forward must do, and whose five (QKᵀ, dO Vᵀ, dV, dK, dQ) a backward
    must do."""
    B, Sq, Hq, _ = q_shape
    return B * Hq * _row_pairs(Sq, k_shape[1], causal, window)


@functools.lru_cache(maxsize=None)
def _row_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int]) -> int:
    pairs = 0
    for i in range(Sq):
        lo, hi = key_range(i, i + 1, Sq, Sk, causal, window)
        pairs += max(0, hi - lo)
    return pairs


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         window: Optional[int], return_lse: bool = False) -> Tuple[int, int]:
    """(flops, bytes) that a forward needs: 4·D flops a pair (``work``);
    q and v read and out written once at their item sizes (out is shaped
    and typed as q), k once, and lse (B, Hq, Sq) f32 when returned."""
    B, Sq, Hq, D = q.shape
    nbytes = 2 * _nbytes(q) + _nbytes(k) + _nbytes(v)
    if return_lse:
        nbytes += B * Hq * Sq * 4
    return work(q.shape, k.shape, causal, window) * 4 * D, nbytes


def cost_bwd(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
             causal: bool, window: Optional[int]) -> Tuple[int, int]:
    """(flops, bytes) that the backward needs: 10·D flops a pair (its five
    products, ``work``); q, out and dout read and dq written (four q-sized
    tensors), k and v read and dk and dv written (four k-sized), lse
    read."""
    D = q.shape[-1]
    nbytes = 4 * _nbytes(q) + 4 * _nbytes(k) + _nbytes(lse)
    return work(q.shape, k.shape, causal, window) * 5 * 2 * D, nbytes
