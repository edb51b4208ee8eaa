"""Multi-pattern DFA scan (Aho-Corasick) — the paper's regex accelerator.

``dfa_regex`` steps each packet through the dense DFA over its valid prefix
and sums ``out_count`` of every state it enters: (B,) int32 match counts.
On a CUDA tensor it launches the hand-written kernel (``csrc/dfa_regex.cu``);
on a CPU tensor it runs ``dfa_scan_torch``, the plain PyTorch version of
the same walk, which is also the kernel's oracle on the card.

Match semantics: out_count[s] occurrences are credited when entering state
s, for bytes j < length only (``length`` is clamped to [0, L]).

The kernel takes the table as ``prepare`` leaves it, once per rule set and
on the host: each entry packed as ``next | out_count[next] << 16`` (one
lookup a step), and the table's synchronisation depth d (``sync_depth``).
With a finite d a packet is cut into segments walked in parallel: segment
i > 0 starts at state 0, d bytes before its first byte, and counts matches
from its first byte on. After any d bytes the walk's state no longer
depends on where it started, so each segment's state at its first byte is
the serial walk's and the segments' counts sum to the serial count
exactly (``segmented_scan_numpy`` is that walk, written out).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import hw
from repro_torch.kernels import _build

THREADS = 1024           # threads per block of the CUDA kernel
MAX_SEGMENTS = 8         # lanes that walk one packet (a power of two <= 32)
CHUNK = 16               # payload bytes a thread takes from shared memory
STAGES = 2               # payload chunks staged ahead: double buffering
COUNT_LIMIT = 1 << 16    # out_count must fit the packed entry's 16 bits


def dfa_scan_torch(payload: torch.Tensor, length: torch.Tensor,
                   table: torch.Tensor, out_count: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version: serial per-byte stepping over all B packets at once.
    payload: (B, L) uint8; length: (B,); table: (S, 256); out_count: (S,)."""
    B, L = payload.shape
    dev = payload.device
    tbl = table.to(device=dev, dtype=torch.int64).reshape(-1)
    oc = out_count.to(device=dev, dtype=torch.int32)
    length = length.to(device=dev, dtype=torch.int64)
    state = torch.zeros(B, dtype=torch.int64, device=dev)
    matches = torch.zeros(B, dtype=torch.int32, device=dev)
    for j in range(L):
        valid = j < length
        nxt = tbl[state * 256 + payload[:, j].to(torch.int64)]
        state = torch.where(valid, nxt, state)
        matches += torch.where(valid, oc[state], 0)
    return matches


# -- the prepared table -----------------------------------------------------

class Prepared(NamedTuple):
    """A DFA as the kernel takes it: ``packed`` (S, 256) int32 entries
    ``next | out_count[next] << 16``; ``depth`` the synchronisation depth
    (None when the table has none)."""
    packed: np.ndarray
    depth: Optional[int]


def sync_depth(table: np.ndarray) -> Optional[int]:
    """The least d such that delta(q, w) == delta(0, w) for every state q
    reachable from 0 and every byte string w of length d; None when no such
    d exists (a DFA that remembers something forever, such as parity).

    Breadth-first over pairs of states: level k holds the pairs
    (delta(q, w), delta(0, w)) over |w| = k that still differ. d is the
    first level with none left; a cycle among differing pairs means there
    is no d. For an Aho-Corasick table d is the longest pattern."""
    table = np.asarray(table, dtype=np.int64)
    S = table.shape[0]
    reach = np.zeros(S, bool)
    reach[0] = True
    frontier = np.array([0])
    while frontier.size:
        nxt = np.unique(table[frontier].reshape(-1))
        frontier = nxt[~reach[nxt]]
        reach[frontier] = True
    # every differing pair (a, b) reachable from {(q, 0)}, with its edges
    start = np.flatnonzero(reach)
    start = start[start != 0] * S                    # pairs (q, 0), q != 0
    seen = np.zeros(S * S, bool)
    seen[start] = True
    frontier = start
    while frontier.size:
        succ = _pair_successors(table, frontier, S)
        succ = np.unique(succ[succ >= 0])
        frontier = succ[~seen[succ]]
        seen[frontier] = True
    nodes = np.flatnonzero(seen)
    if nodes.size == 0:
        return 0
    # longest path (in nodes) from a start pair, by Kahn's topological order
    index = np.full(S * S, -1, np.int64)
    index[nodes] = np.arange(nodes.size)
    succ = _pair_successors(table, nodes, S)         # (n, 256), -1 = equal
    src = np.repeat(np.arange(nodes.size), 256)
    dst = index[succ.reshape(-1)]
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    # drop repeated edges so in-degrees count distinct successors
    edges = np.unique(src * nodes.size + dst)
    src, dst = edges // nodes.size, edges % nodes.size
    indeg = np.bincount(dst, minlength=nodes.size)
    depth = np.zeros(nodes.size, np.int64)
    depth[index[start]] = 1
    by_src = np.argsort(src, kind="stable")
    src, dst = src[by_src], dst[by_src]
    bounds = np.searchsorted(src, np.arange(nodes.size + 1))
    ready = list(np.flatnonzero(indeg == 0))
    done = 0
    while ready:
        u = ready.pop()
        done += 1
        out = dst[bounds[u]:bounds[u + 1]]
        if out.size:
            depth[out] = np.maximum(depth[out], depth[u] + 1)
            indeg[out] -= 1
            ready.extend(out[indeg[out] == 0].tolist())
    if done < nodes.size:
        return None                                  # a cycle: no finite d
    return int(depth.max())


def _pair_successors(table: np.ndarray, pairs: np.ndarray, S: int
                     ) -> np.ndarray:
    """(n, 256) successor pair ids of pair ids a * S + b under every byte;
    -1 where the two states meet."""
    a, b = pairs // S, pairs % S
    na, nb = table[a], table[b]
    return np.where(na == nb, -1, na * S + nb)


def prepare(table: np.ndarray, out_count: np.ndarray) -> Prepared:
    """Pack the table for the kernel and find its synchronisation depth.
    Raises when a state id or a count does not fit its 16 bits."""
    table = np.asarray(table)
    out_count = np.asarray(out_count)
    S = table.shape[0]
    if table.ndim != 2 or table.shape[1] != 256 or out_count.shape != (S,):
        raise ValueError(f"dfa_regex: table {table.shape} and out_count "
                         f"{out_count.shape} are not (S, 256) and (S,)")
    if S > 256 or table.min(initial=0) < 0 or table.max(initial=0) >= S:
        raise ValueError(f"dfa_regex: a table of {S} states with entries in "
                         f"[{table.min()}, {table.max()}] does not pack")
    if out_count.min(initial=0) < 0 or out_count.max(initial=0) >= COUNT_LIMIT:
        raise ValueError(f"dfa_regex: out_count must lie in [0, "
                         f"{COUNT_LIMIT}) to pack, got [{out_count.min()}, "
                         f"{out_count.max()}]")
    t = table.astype(np.int64)
    packed = (t | (out_count.astype(np.int64)[t] << 16)).astype(np.uint32)
    return Prepared(packed.view(np.int32), sync_depth(table))


# -- the walk the kernel does, written out ---------------------------------

def segment_bounds(L: int, segments: int, depth: Optional[int]
                   ) -> list:
    """(warm-up start, count start) of each segment of an L-byte row: the
    segment counts from its count start to the next one's (or the row's
    valid end), walking from state 0 at its warm-up start."""
    if depth is None:
        segments = 1
    span = -(-L // segments)
    return [(max(0, i * span - depth) if i else 0, i * span)
            for i in range(segments)]


def segmented_scan_numpy(payload: np.ndarray, length: np.ndarray,
                         prepared: Prepared, segments: int) -> np.ndarray:
    """The CUDA kernel's walk in numpy: each packet cut into ``segments``
    segments, each walked from state 0 over its warm-up, its matches read
    from the packed entries and counted from its own first byte; the
    packet's count is the segments' sum (int32, wrapping as the kernel's
    adds do)."""
    B, L = payload.shape
    packed = prepared.packed.view(np.uint32).astype(np.int64)
    n = np.clip(length.astype(np.int64), 0, L)
    bounds = segment_bounds(L, segments, prepared.depth)
    total = np.zeros(B, np.int64)
    for i, (warm, first) in enumerate(bounds):
        last = bounds[i + 1][1] if i + 1 < len(bounds) else L
        state = np.zeros(B, np.int64)
        for j in range(warm, last):
            live = j < n
            e = packed[state, payload[:, j].astype(np.int64)]
            state = np.where(live, e & 0xFFFF, state)
            if j >= first:
                total += np.where(live, e >> 16, 0)
    return (total & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


# -- the CUDA kernel --------------------------------------------------------

def smem_bytes(num_states: int) -> int:
    """Shared memory the kernel's packed table takes."""
    return num_states * 256 * 4


def plan(B: int, L: int, num_states: int, depth: Optional[int],
         sms: int = hw.NUM_SMS) -> Tuple[int, int]:
    """(segments per packet, 16-byte chunks a thread stages at once).

    Chunks: 1 (each thread stages one 16-byte chunk ahead of the one it
    walks) where the table leaves room for it; 0 when it does not, and
    then the threads read their payload from device memory. Segments: the
    most lanes a packet (a power of two up to ``MAX_SEGMENTS``) that still
    keep the walks within one block of ``THREADS`` on every SM, none
    shorter than 4 d bytes; one without a finite depth. The walk is bound
    by the shared-memory lookups, so more segments than that only add
    warm-up steps."""
    table = smem_bytes(num_states)
    chunks = int(table + STAGES * CHUNK * THREADS <= hw.SMEM_PER_BLOCK_MAX)
    if depth is None or B == 0:
        return 1, chunks
    segs = 1
    while (segs < MAX_SEGMENTS and B * segs * 2 <= sms * THREADS
           and -(-L // (segs * 2)) >= 4 * max(depth, 1)):
        segs *= 2
    return segs, chunks


def dfa_regex_cuda(payload: torch.Tensor, length: torch.Tensor,
                   packed: torch.Tensor, depth: Optional[int]
                   ) -> torch.Tensor:
    """Launch the CUDA kernel on a table from ``prepare``: ``packed`` on
    the payload's CUDA device, ``depth`` its synchronisation depth."""
    name = "dfa_regex"
    dev = _build.require_cuda(name, payload, length, packed)
    _build.require_dtype(name, "payload", payload, torch.uint8)
    _build.require_dtype(name, "length", length, torch.int32)
    _build.require_dtype(name, "packed table", packed, torch.int32)
    if payload.dim() != 2:
        raise ValueError(f"{name}: payload must be (B, L), got "
                         f"{tuple(payload.shape)}")
    B, L = payload.shape
    S = packed.shape[0]
    if (length.shape != (B,) or packed.dim() != 2 or packed.shape[1] != 256
            or S > 256):
        raise ValueError(f"{name}: shapes length {tuple(length.shape)}, "
                         f"packed table {tuple(packed.shape)} do not fit "
                         f"payload {tuple(payload.shape)}")
    if smem_bytes(S) > hw.SMEM_PER_BLOCK_MAX:
        raise ValueError(f"{name}: a {S}-state table needs {smem_bytes(S)} B "
                         f"of shared memory, more than the "
                         f"{hw.SMEM_PER_BLOCK_MAX} B a block can have")
    if depth is not None and depth < 0:
        raise ValueError(f"{name}: depth must be >= 0 or None, got {depth}")
    segs, chunks = plan(B, L, S, depth, hw.device_spec(dev.index or 0).sms)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    _build.launch(name, dev, payload.data_ptr(), B, L, length.data_ptr(),
                  packed.data_ptr(), S, -1 if depth is None else depth, segs,
                  chunks, out.data_ptr())
    return out


def dfa_regex(payload: torch.Tensor, length: torch.Tensor,
              table: torch.Tensor, out_count: torch.Tensor,
              packed: Optional[torch.Tensor] = None,
              depth: Optional[int] = None) -> torch.Tensor:
    """(B,) int32 match counts: the kernel for CUDA tensors, on the table
    ``prepare`` packed (``packed``, ``depth``); the plain version for CPU
    tensors."""
    if payload.is_cuda:
        if packed is None:
            raise ValueError("dfa_regex: the kernel takes the table as "
                             "dfa_regex.prepare packs it; pass packed and "
                             "depth")
        return dfa_regex_cuda(payload, length, packed, depth)
    return dfa_scan_torch(payload, length, table, out_count)
