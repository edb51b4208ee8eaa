"""Single-token decode attention over a KV cache (flash-decoding).

Decode attention attends one query token per row, q (B, Hq, D), over
k/v (B, S, Hkv, D), keeping cache positions ``s < kv_len[b]``; f32 math,
output (B, Hq, D) in q's dtype. q and the cache may each be float32 or
bfloat16. ``decode_attention_cuda`` launches the hand-written kernel
(``csrc/decode_attention.cu``: the cache split over blocks, the splits
merged in the same launch); ``decode_attention_torch`` is the plain PyTorch
version of the Pallas kernel's online-softmax recurrence over key blocks,
the CPU path and the kernel's oracle on the card; ``split_merge_torch``
writes out the kernel's own split and merge order. ``ops.decode_attention``
picks between them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import LSE_EMPTY, NEG_INF, check_shapes

THREADS = 128
WARPS = THREADS // 32
CLUSTER = 8             # splits merged through distributed shared memory
MAX_OUT = 2048          # G·D a block holds
MAX_KEYS_PER_STAGE = 8  # rows of K (and V) a warp stages at once
STAGE_BYTES = 8192      # at most this much of K and V a warp stages at once
KEYS_PER_WARP = 8       # most keys a warp takes, as the split plan sets it

# (device, stream) -> int32 arrival counters, zeroed once when allocated;
# the kernel's last block of each merge sets its counter back to 0.
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def decode_attention_torch(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: torch.Tensor, *,
                           scale: Optional[float] = None,
                           block_k: int = 512, return_lse: bool = False):
    """Plain version: the Pallas kernel's recurrence — running (max, sum,
    acc) per (b, kv head, g) over key blocks of ``block_k``, probabilities
    multiplied by the ``s < kv_len`` mask. With ``return_lse`` returns
    (out, lse (B, Hq) f32): each row's log-sum-exp of its scaled logits,
    ``LSE_EMPTY`` where it has no valid key."""
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
    out = (acc / safe[..., None]).reshape(B, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, LSE_EMPTY, m + torch.log(safe))
    return out, lse.reshape(B, Hq)


def row_lanes(D: int) -> int:
    """Lanes of a warp that hold one cache row: all 32 from D 64 on, else
    D / 2 (2 dims a lane), and the warp walks 32 / that many rows a step."""
    return 32 if D >= 64 else D // 2


def max_group(D: int) -> int:
    """Most query heads per KV head the kernel has an instance for at head
    dim D: G·D within ``MAX_OUT``, at most 32, and at most 16 below D 64,
    where a warp's side-by-side rows take more registers a head (G 32
    spilled at D 16 on the H100)."""
    return min(32 if D >= 64 else 16, MAX_OUT // D)


def splits(S: int) -> Tuple[int, int]:
    """(number of splits, keys per split) of an S-deep cache: as few
    clusters of ``CLUSTER`` splits as keep every warp at most
    ``KEYS_PER_WARP`` keys, in whole multiples of ``WARPS`` keys. kv_len is
    not read on the host. Each cluster with keys costs a merge across
    clusters, which on the H100 took longer than spreading a small cache
    over more SMs gained (one cluster of 8-key splits beat two of 4-key
    splits at the engine's 64-deep cache)."""
    clusters = max(1, -(-S // (CLUSTER * WARPS * KEYS_PER_WARP)))
    chunk = -(-S // (clusters * CLUSTER))
    chunk = -(-chunk // WARPS) * WARPS
    nsplit = -(-S // chunk)
    return -(-nsplit // CLUSTER) * CLUSTER, chunk


def stage_plan(chunk: int, D: int, itemsize: int) -> Tuple[int, int]:
    """(keys a warp stages at once, stages): all of a warp's keys in one
    stage where they fit, else two stages of at most ``STAGE_BYTES``."""
    per_warp = -(-chunk // WARPS)
    kt = max(1, min(MAX_KEYS_PER_STAGE, per_warp,
                    STAGE_BYTES // (2 * D * itemsize)))
    return kt, 1 if per_warp <= kt else 2


def split_merge_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor, *, scale: Optional[float] = None
                      ) -> torch.Tensor:
    """The CUDA kernel's arithmetic in its own order, in plain PyTorch:
    splits of ``splits(S)``, each cut over ``WARPS`` warps that
    walk their keys in stages of ``stage_plan`` and batches of 8 keys (32 /
    G where G >= 8, and no fewer than the 64 / D rows a step takes below D
    64; the last 2 or fewer keys of a stage alone) with a
    running (max, sum, acc); the warps
    merged into a block partial, 8 block partials into a cluster partial,
    the clusters with keys into the output. (The kernel takes its
    exponentials in base 2, with q scaled by log2 e: the same function.)
    The CPU tests hold it against the Pallas kernel."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, G, D) * scale
    gm = 1 << (G - 1).bit_length()                   # G to a power of two
    kb = 32 // gm if gm >= 8 else 8                  # keys a batch
    kb = max(kb, 32 // row_lanes(D))                 # a step's rows at least
    out = torch.zeros((B, Hkv, G, D), dtype=torch.float32)
    nsplit, chunk = splits(S)
    per_warp = -(-chunk // WARPS)
    kt, _ = stage_plan(chunk, D, k.element_size())

    def merge(parts):
        m = torch.stack([p[0] for p in parts])       # (n, G)
        mx = m.max(dim=0).values
        f = torch.exp(m - mx)
        return (mx, (f * torch.stack([p[1] for p in parts])).sum(0),
                (f[..., None] * torch.stack([p[2] for p in parts])).sum(0))

    for b in range(B):
        n = max(0, min(int(kv_len[b]), S))
        if n == 0:
            continue
        nvalid = -(-n // chunk)
        nclusters = -(-nvalid // CLUSTER)
        for h in range(Hkv):
            clusters = []
            for c in range(nclusters):
                blocks = []
                for sp in range(c * CLUSTER, (c + 1) * CLUSTER):
                    s0, s1 = sp * chunk, min(sp * chunk + chunk, n)
                    warps = []
                    for w in range(WARPS):
                        w0 = s0 + w * per_warp
                        w1 = min(w0 + per_warp, s1)
                        m = torch.full((G,), NEG_INF)
                        l = torch.zeros(G)
                        acc = torch.zeros((G, D))
                        batches = []
                        for t in range(w0, w1, kt):
                            j, end = t, min(t + kt, w1)
                            while j < end:       # the last <= 2 keys alone
                                step = kb if end - j > 2 else min(kb, 2)
                                batches.append((j, min(j + step, end)))
                                j += step
                        for j, j1 in batches:
                            s = qf[b, h] @ k[b, j:j1, h].float().T   # (G, n)
                            mx = torch.maximum(m, s.max(dim=1).values)
                            alpha = torch.exp(m - mx)
                            p = torch.exp(s - mx[:, None])
                            l = alpha * l + p.sum(dim=1)
                            acc = acc * alpha[:, None] + p @ v[b, j:j1,
                                                               h].float()
                            m = mx
                        warps.append((m, l, acc))
                    blocks.append(merge(warps))
                clusters.append(merge(blocks))
            _, l, acc = merge(clusters)
            out[b, h] = acc / torch.where(l == 0, 1.0, l)[:, None]
    return out.reshape(B, Hq, D).to(q.dtype)


def _arrival_counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters for launches on ``dev``'s current
    stream, all 0 between launches: zeroed when first allocated (or grown),
    then set back to 0 by the kernel's last block of each merge."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    got = _counters.get(key)
    if got is None or got.numel() < n:
        got = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _counters[key] = got
    return got


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Launch the CUDA kernel; every tensor contiguous on one CUDA
    device, kv_len int32, k and v of one dtype. One launch per call. With
    ``return_lse`` the kernel's last merge also writes each row's
    log-sum-exp (B, Hq) f32, in natural log (the kernel merges in base
    2), ``LSE_EMPTY`` where the row has no valid key: returns (out,
    lse)."""
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
    if k.dtype != v.dtype:
        raise TypeError(f"{name}: k and v must share a dtype, got {k.dtype} "
                        f"and {v.dtype}")
    G = Hq // Hkv
    if G > max_group(D):
        raise ValueError(f"{name}: {G} query heads per KV head at D={D} "
                         f"exceed the {max_group(D)} the kernel has "
                         f"instances for (G·D within its {MAX_OUT} outputs "
                         f"per block)")
    if B * Hkv > 65535:
        raise ValueError(f"{name}: B*Hkv={B * Hkv} exceeds the grid")
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=dev) \
        if return_lse else None
    done = (lambda: (out, lse)) if return_lse else (lambda: out)
    if B == 0 or S == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(LSE_EMPTY)
        return done()
    nsplit, chunk = splits(S)
    kt, stages = stage_plan(chunk, D, k.element_size())
    ncl = nsplit // CLUSTER
    part_acc = torch.empty((B * Hkv * ncl * G * D,), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((B * Hkv * ncl * CLUSTER * G * 2,),
                          dtype=torch.float32, device=dev)
    if _build.traced(q):
        # kv_len's values are unknown here: every row counts its whole
        # cache, as a decode step at the cache's last position does (the
        # dry run decodes at pos = S - 1); the arrival counters are
        # allocated once per stream and kept, outside any step
        _build.trace_launch(name, *cost(q, k, B * S, return_lse))
        return done()
    counters = _arrival_counters(dev, B * Hkv * CLUSTER)
    _build.launch(name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  kv_len.data_ptr(), out.data_ptr(),
                  0 if lse is None else lse.data_ptr(), part_acc.data_ptr(),
                  part_ml.data_ptr(), counters.data_ptr(), B, S, Hq, Hkv, D,
                  nsplit, chunk, kt, stages, scale,
                  int(q.dtype == torch.bfloat16),
                  int(k.dtype == torch.bfloat16))
    return done()


def work(kv_len: torch.Tensor, S: int, Hq: int) -> int:
    """Query-head/key pairs inside the ``s < kv_len`` mask, summed over the
    batch: each costs 4·D flops (q·k and p·v)."""
    return int(kv_len.clamp(0, S).sum()) * Hq


def cost(q: torch.Tensor, k: torch.Tensor, keys: int,
         return_lse: bool = False) -> Tuple[int, int]:
    """(flops, bytes) of one call over ``keys`` valid cache rows in all
    (``kv_len`` summed over the batch): 4·D flops per query head and key
    (``work``); q read and out written at q's item size, kv_len (B,)
    int32, each valid row's k and v once at the cache's item size, and
    with ``return_lse`` the (B, Hq) f32 lse written."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    nbytes = (2 * q.numel() * q.element_size() + 4 * B
              + keys * Hkv * D * 2 * k.element_size()
              + 4 * B * Hq * bool(return_lse))
    return keys * Hq * 4 * D, nbytes
