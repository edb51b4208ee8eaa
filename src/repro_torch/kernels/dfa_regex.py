"""Multi-pattern DFA scan (Aho-Corasick) — the paper's regex accelerator.

``dfa_regex`` steps each packet through the dense DFA over its valid prefix
and sums ``out_count`` of every state it enters: (B,) int32 match counts.
On a CUDA tensor it launches the hand-written kernel (``csrc/dfa_regex.cu``);
on a CPU tensor it runs ``dfa_scan_torch``, the plain PyTorch version of
the same walk, which is also the kernel's oracle on the card.

Match semantics: out_count[s] occurrences are credited when entering state
s, for bytes j < length only (``length`` is clamped to [0, L]).

The kernel takes the table as ``prepare`` leaves it, once per rule set and
on the host, in one of two forms. A table that fits a block's shared
memory with counts in [0, 2^16) is packed: each entry ``next |
out_count[next] << 16`` (one lookup a step). Any other table the reference
takes is wide: 16-bit next states (32-bit past 65,536 states) beside the
int32 counts, in shared memory where they fit and read from device memory
(where L2 keeps them) where they do not. Either comes with the table's
synchronisation depth d (``sync_depth``).
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
PACKED_MAX_STATES = hw.SMEM_PER_BLOCK_MAX // (256 * 4)   # 227: in one block
WIDE16_MAX_STATES = 1 << 16   # next states fit 16 bits up to here
# sync_depth's budget: pair expansions (each reads 256 successors) and the
# distinct differing pairs it keeps; past either it returns None (exact:
# one segment a packet). A 1,000-state Aho-Corasick table needs ~10^4.
PAIR_WORK = 1 << 18
PAIR_CHUNK = 4096             # pairs expanded at once (8 MB of successors)


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
    """A DFA as the kernel takes it. Packed form (``counts`` None):
    ``packed`` (S, 256) int32 entries ``next | out_count[next] << 16``.
    Wide form: ``packed`` the (S, 256) next states alone, uint16 stored as
    int16 (int32 past ``WIDE16_MAX_STATES``), and ``counts`` the (S,) int32
    out_count. ``depth`` the synchronisation depth (None when the table has
    none, or it is past ``sync_depth``'s budget)."""
    packed: np.ndarray
    depth: Optional[int]
    counts: Optional[np.ndarray] = None

    @property
    def form(self) -> str:
        return table_form(self.packed.dtype, self.counts is not None)


def table_form(entry_dtype, has_counts: bool) -> str:
    """"packed", "wide16" or "wide32", from the entries' dtype (numpy or
    torch) and whether counts come beside them."""
    if not has_counts:
        return "packed"
    return "wide16" if str(entry_dtype).endswith("int16") else "wide32"


def sync_depth(table: np.ndarray) -> Optional[int]:
    """The least d such that delta(q, w) == delta(0, w) for every state q
    reachable from 0 and every byte string w of length d; None when no such
    d exists (a DFA that remembers something forever, such as parity), or
    when finding it would pass the budget (``PAIR_WORK``): None is always
    exact, since the kernel then walks each packet as one segment.

    Level by level over pairs of states: level k holds the pairs
    (delta(q, w), delta(0, w)) over |w| = k that still differ; d is the
    first level with none left. A path with more levels than the distinct
    pairs seen so far repeats a pair, so it is a cycle: then there is no d.
    For an Aho-Corasick table d is the longest pattern. Memory is bounded
    by the budget, not by S^2."""
    table = np.asarray(table, dtype=np.int64)
    S = table.shape[0]
    reach = np.zeros(S, bool)
    reach[0] = True
    frontier = np.array([0])
    while frontier.size:
        nxt = _successors(table, frontier)
        frontier = nxt[~reach[nxt]]
        reach[frontier] = True
    frontier = np.flatnonzero(reach)
    frontier = frontier[frontier != 0] * S           # pairs (q, 0), q != 0
    seen = frontier
    depth, work = 0, 0
    while frontier.size:
        depth += 1
        work += frontier.size
        if depth > seen.size or work > PAIR_WORK:
            return None                              # a cycle, or too costly
        frontier = _pair_successors(table, frontier, S, PAIR_WORK - work)
        if frontier is None:                         # the next level: too
            return None                              # costly
        seen = np.union1d(seen, frontier)
    return depth


def _successors(table: np.ndarray, states: np.ndarray) -> np.ndarray:
    """The distinct successors of ``states`` under every byte."""
    out = [np.unique(table[states[i:i + PAIR_CHUNK]])
           for i in range(0, states.size, PAIR_CHUNK)]
    return np.unique(np.concatenate(out)) if out else states[:0]


def _pair_successors(table: np.ndarray, pairs: np.ndarray, S: int,
                     limit: int) -> Optional[np.ndarray]:
    """The distinct successor pair ids a' * S + b' of pair ids a * S + b
    under every byte, where the two states still differ; None as soon as
    there are more than ``limit`` of them."""
    out = pairs[:0]
    for i in range(0, pairs.size, PAIR_CHUNK):
        p = pairs[i:i + PAIR_CHUNK]
        na, nb = table[p // S], table[p % S]
        out = np.union1d(out, (na * S + nb)[na != nb])
        if out.size > limit:
            return None
    return out


def prepare(table: np.ndarray, out_count: np.ndarray) -> Prepared:
    """The table in the kernel's form, and its synchronisation depth.
    Packed where it fits a block's shared memory (S <= 227) with counts in
    [0, 2^16); wide otherwise. Raises only on what the reference cannot
    walk either: a shape other than (S, 256) and (S,), or an entry outside
    [0, S)."""
    table = np.asarray(table)
    out_count = np.asarray(out_count)
    S = table.shape[0] if table.ndim == 2 else 0
    if S == 0 or table.shape[1] != 256 or out_count.shape != (S,):
        raise ValueError(f"dfa_regex: table {table.shape} and out_count "
                         f"{out_count.shape} are not (S, 256) and (S,)")
    if table.min() < 0 or table.max() >= S:
        raise ValueError(f"dfa_regex: a table of {S} states has entries "
                         f"outside [0, {S}): [{table.min()}, {table.max()}]")
    depth = sync_depth(table)
    counts = out_count.astype(np.int32)      # as the reference casts them
    if (S <= PACKED_MAX_STATES and counts.min() >= 0
            and counts.max() < COUNT_LIMIT):
        t = table.astype(np.int64)
        packed = t | (counts.astype(np.int64)[t] << 16)
        return Prepared(packed.astype(np.uint32).view(np.int32), depth)
    if S <= WIDE16_MAX_STATES:
        nxt = table.astype(np.uint16).view(np.int16)
    else:
        nxt = table.astype(np.int32)
    return Prepared(np.ascontiguousarray(nxt), depth, counts)


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
    if prepared.counts is None:                  # next | count << 16
        packed = prepared.packed.view(np.uint32).astype(np.int64)
        nxt, cnt = packed & 0xFFFF, packed >> 16
    else:                                        # next; count of the state
        ent = prepared.packed
        nxt = (ent.view(np.uint16) if ent.dtype == np.int16 else ent
               ).astype(np.int64)
        cnt = prepared.counts.astype(np.int64)[nxt]
    n = np.clip(length.astype(np.int64), 0, L)
    bounds = segment_bounds(L, segments, prepared.depth)
    total = np.zeros(B, np.int64)
    for i, (warm, first) in enumerate(bounds):
        last = bounds[i + 1][1] if i + 1 < len(bounds) else L
        state = np.zeros(B, np.int64)
        for j in range(warm, last):
            live = j < n
            byte = payload[:, j].astype(np.int64)
            c = cnt[state, byte]
            state = np.where(live, nxt[state, byte], state)
            if j >= first:
                total += np.where(live, c, 0)
    return (total & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


# -- the CUDA kernel --------------------------------------------------------

def smem_bytes(num_states: int, form: str = "packed") -> int:
    """Shared memory a table of this form takes in the kernel: the packed
    entries; or the wide form's next states and int32 counts, each 16-byte
    aligned."""
    if form == "packed":
        return num_states * 256 * 4
    entry = 2 if form == "wide16" else 4
    return _align16(num_states * 256 * entry) + _align16(num_states * 4)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def in_shared(num_states: int, form: str = "packed") -> bool:
    """Whether the kernel keeps the table in shared memory; else it reads
    it from device memory."""
    return smem_bytes(num_states, form) <= hw.SMEM_PER_BLOCK_MAX


def plan(B: int, L: int, num_states: int, depth: Optional[int],
         sms: int = hw.NUM_SMS, form: str = "packed") -> Tuple[int, int]:
    """(segments per packet, 16-byte chunks a thread stages at once).

    Chunks: 1 (each thread stages one 16-byte chunk ahead of the one it
    walks) where the table leaves room for it in shared memory (a table
    read from device memory leaves all of it); 0 when it does not, and
    then the threads read their payload from device memory. Segments: the
    most lanes a packet (a power of two up to ``MAX_SEGMENTS``) that still
    keep the walks within one block of ``THREADS`` on every SM, none
    shorter than 4 d bytes; one without a finite depth. The walk is bound
    by the table lookups, so more segments than that only add warm-up
    steps."""
    table = smem_bytes(num_states, form) if in_shared(num_states, form) \
        else 0
    chunks = int(table + STAGES * CHUNK * THREADS <= hw.SMEM_PER_BLOCK_MAX)
    if depth is None or B == 0:
        return 1, chunks
    segs = 1
    while (segs < MAX_SEGMENTS and B * segs * 2 <= sms * THREADS
           and -(-L // (segs * 2)) >= 4 * max(depth, 1)):
        segs *= 2
    return segs, chunks


FORM_CODES = {"packed": 0, "wide16": 2, "wide32": 4}   # the launcher's


def dfa_regex_cuda(payload: torch.Tensor, length: torch.Tensor,
                   packed: torch.Tensor, depth: Optional[int],
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on a table from ``prepare`` (``packed``,
    ``depth`` and, for the wide form, ``counts``), on the payload's CUDA
    device."""
    name = "dfa_regex"
    extra = () if counts is None else (counts,)
    dev = _build.require_cuda(name, payload, length, packed, *extra)
    _build.require_dtype(name, "payload", payload, torch.uint8)
    _build.require_dtype(name, "length", length, torch.int32)
    form = table_form(packed.dtype, counts is not None)
    _build.require_dtype(name, "packed table", packed,
                         torch.int16 if form == "wide16" else torch.int32)
    if counts is not None:
        _build.require_dtype(name, "counts", counts, torch.int32)
    if payload.dim() != 2:
        raise ValueError(f"{name}: payload must be (B, L), got "
                         f"{tuple(payload.shape)}")
    B, L = payload.shape
    S = packed.shape[0]
    if (length.shape != (B,) or packed.dim() != 2 or packed.shape[1] != 256
            or (counts is not None and counts.shape != (S,))):
        raise ValueError(f"{name}: shapes length {tuple(length.shape)}, "
                         f"table {tuple(packed.shape)}, counts "
                         f"{None if counts is None else tuple(counts.shape)}"
                         f" do not fit payload {tuple(payload.shape)}")
    if form == "packed" and not in_shared(S):
        raise ValueError(f"{name}: a packed {S}-state table needs "
                         f"{smem_bytes(S)} B of shared memory, more than the "
                         f"{hw.SMEM_PER_BLOCK_MAX} B a block can have")
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: the table must start 16-byte aligned")
    if form == "wide16" and S > WIDE16_MAX_STATES:
        raise ValueError(f"{name}: {S} states do not fit 16-bit entries")
    if depth is not None and depth < 0:
        raise ValueError(f"{name}: depth must be >= 0 or None, got {depth}")
    segs, chunks = plan(B, L, S, depth, hw.device_spec(dev.index or 0).sms,
                        form)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    _build.launch(name, dev, payload.data_ptr(), B, L, length.data_ptr(),
                  packed.data_ptr(),
                  None if counts is None else counts.data_ptr(), S,
                  FORM_CODES[form], int(in_shared(S, form)),
                  -1 if depth is None else depth, segs, chunks,
                  out.data_ptr())
    return out


def dfa_regex(payload: torch.Tensor, length: torch.Tensor,
              table: torch.Tensor, out_count: torch.Tensor,
              packed: Optional[torch.Tensor] = None,
              depth: Optional[int] = None,
              counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) int32 match counts: the kernel for CUDA tensors, on the table
    as ``prepare`` left it (``packed``, ``depth``, ``counts``); the plain
    version for CPU tensors."""
    if payload.is_cuda:
        if packed is None:
            raise ValueError("dfa_regex: the kernel takes the table as "
                             "dfa_regex.prepare packs it; pass packed and "
                             "depth")
        return dfa_regex_cuda(payload, length, packed, depth, counts)
    return dfa_scan_torch(payload, length, table, out_count)
