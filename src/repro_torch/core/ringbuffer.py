"""Lock-free per-pipeline ring buffers (paper §5.1.2).

The paper allocates each (sub-)pipeline dedicated ingress / egress /
inter-stage rings out of a per-application packet-buffer pool so that
parallel pipelines never contend on a shared buffer. On the GPU the same
structure is a fixed-capacity device tensor with monotonic head/tail
cursors; the single-writer discipline per lane makes it lock-free by
construction. Cursors are monotonic int32; a slot index is the cursor
``& (cap - 1)``, which is exact across the int32 wrap because ``cap`` is a
power of two. Occupancy is simply ``tail - head``.

Rings are updated IN PLACE and the functions return the same Ring. The
reference is functional, but its data plane donates the ring to the fused
dispatch (``executor.py``) so XLA updates the allocation in place too; no
caller keeps an old ring.

Two layouts share the Ring class:

  * single-lane (``make_ring``/``push``/``pop``/``peek``): leaves are
    (cap, ...), cursors are 0-d tensors;
  * stacked multi-lane (``make_rings``/``push_many``/``pop_many``): leaves
    are (lanes, cap, ...), cursors are (lanes,) — every pipeline's ingress
    ring lives in ONE device allocation so the data plane pushes/pops all
    pipelines at once. The reference vmaps the single-lane ops; here the
    lane index is written out in the index math.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.graph import bits, take, tree_leaves, tree_map


class Ring:
    """Fixed-capacity FIFO over a tree (PacketBatch, dict, ...) of
    row-tensors."""

    def __init__(self, data: Any, head: torch.Tensor, tail: torch.Tensor,
                 cap: int):
        if cap & (cap - 1):
            raise ValueError(f"ring capacity must be a power of two, got {cap}")
        self.data = data      # tree of (cap, ...) or (lanes, cap, ...) tensors
        self.head = head      # int32 monotonic pop cursor(s)
        self.tail = tail      # int32 monotonic push cursor(s)
        self.cap = int(cap)

    @property
    def occupancy(self) -> torch.Tensor:
        return self.tail - self.head

    @property
    def space(self) -> torch.Tensor:
        return self.cap - self.occupancy


def _slots(cursor: torch.Tensor, k: int, cap: int) -> torch.Tensor:
    """Slot indices cursor + [0, k) modulo cap (cursor int32, any shape)."""
    offs = torch.arange(k, dtype=torch.int64, device=cursor.device)
    return (cursor.to(torch.int64)[..., None] + offs) & (cap - 1)


def make_ring(proto: Any, cap: int) -> Ring:
    """Allocate a ring whose rows match `proto` (a tree of per-row tensors)."""
    data = tree_map(lambda a: torch.zeros((cap,) + tuple(a.shape),
                                          dtype=a.dtype, device=a.device),
                    proto)
    dev = tree_leaves(proto)[0].device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return Ring(data, zero, zero.clone(), cap)


def push(ring: Ring, rows: Any, n=None) -> Ring:
    """Append the first `n` rows of `rows` (default: all). Caller must ensure
    space; on overflow the oldest unread entries are overwritten."""
    k = tree_leaves(rows)[0].shape[0]
    if n is None:
        n = k
    n = torch.as_tensor(n, dtype=torch.int32, device=ring.tail.device)
    idx = _slots(ring.tail, k, ring.cap)
    keep = torch.arange(k, device=idx.device) < n

    def upd(buf, new):
        expand = (slice(None),) + (None,) * (new.dim() - 1)
        cur = bits(buf)[idx]
        bits(buf)[idx] = torch.where(keep[expand], bits(new), cur)
        return buf

    tree_map(upd, ring.data, rows)
    ring.tail += n
    return ring


def pop(ring: Ring, k: int) -> Tuple[Ring, Any, torch.Tensor]:
    """Remove up to `k` rows. Returns (ring, rows, valid_mask); rows beyond the
    current occupancy are garbage and masked out by `valid_mask`."""
    n = torch.clamp(ring.occupancy, max=k)
    idx = _slots(ring.head, k, ring.cap)
    rows = tree_map(lambda buf: take(buf, idx), ring.data)
    valid = torch.arange(k, device=idx.device) < n
    ring.head += n
    return ring, rows, valid


def peek(ring: Ring, k: int) -> Tuple[Any, torch.Tensor]:
    idx = _slots(ring.head, k, ring.cap)
    rows = tree_map(lambda buf: take(buf, idx), ring.data)
    valid = torch.arange(k, device=idx.device) < ring.occupancy
    return rows, valid


# -- stacked multi-lane rings (one allocation for N pipelines) ---------------

def make_rings(proto: Any, cap: int, lanes: int) -> Ring:
    """Allocate `lanes` independent rings in one stacked Ring; rows match
    `proto` (a tree of per-row tensors)."""
    data = tree_map(lambda a: torch.zeros((lanes, cap) + tuple(a.shape),
                                          dtype=a.dtype, device=a.device),
                    proto)
    dev = tree_leaves(proto)[0].device
    return Ring(data, torch.zeros((lanes,), dtype=torch.int32, device=dev),
                torch.zeros((lanes,), dtype=torch.int32, device=dev), cap)


def push_many(ring: Ring, rows: Any, n: torch.Tensor) -> Ring:
    """Append rows[i, :n[i]] to lane i, for all lanes at once.

    `rows` leaves are (lanes, M, ...); `n` is (lanes,) int32. Slots beyond
    n[i] keep their content (masked merge, as the reference's), so lanes
    may carry different occupancies through one fixed-shape call. Caller
    ensures M <= cap and per-lane space >= n[i] (steady state in the
    executor: rings drain to empty every round).
    """
    lanes, M = tree_leaves(rows)[0].shape[:2]
    idx = _slots(ring.tail, M, ring.cap)                       # (lanes, M)
    lane = torch.arange(lanes, device=idx.device)[:, None]
    keep = torch.arange(M, device=idx.device)[None, :] < n[:, None]

    def upd(buf, new):
        expand = (slice(None), slice(None)) + (None,) * (new.dim() - 2)
        cur = bits(buf)[lane, idx]
        bits(buf)[lane, idx] = torch.where(keep[expand], bits(new), cur)
        return buf

    tree_map(upd, ring.data, rows)
    ring.tail += n.to(torch.int32)
    return ring


def pop_many(ring: Ring, k: int) -> Tuple[Ring, Any, torch.Tensor]:
    """Remove up to `k` rows from every lane. Returns (ring, rows, valid):
    rows leaves are (lanes, k, ...); valid is (lanes, k) with rows beyond a
    lane's occupancy masked out (their content is garbage)."""
    n = torch.clamp(ring.occupancy, max=k)                     # (lanes,)
    idx = _slots(ring.head, k, ring.cap)                       # (lanes, k)
    lane = torch.arange(idx.shape[0], device=idx.device)[:, None]
    rows = tree_map(lambda buf: take(buf, (lane, idx)), ring.data)
    valid = torch.arange(k, device=idx.device)[None, :] < n[:, None]
    ring.head += n
    return ring, rows, valid
