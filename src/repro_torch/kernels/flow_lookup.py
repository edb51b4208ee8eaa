"""Exact-match flow-classification lookup — the megaflow fast-path kernel.

The flow cache (``core.flowcache``) keeps fid -> (pipeline, epoch) in an
open-addressed table with a BOUNDED probe window: a key may only live in the
``window`` consecutive slots starting at its hash bucket. Lookup gathers the
window, compares keys and takes the first live match; deletion needs no
tombstones.

Implementations of the same probe, pinned bit-identical to each other and
to the JAX package's numpy/jnp/Pallas versions in the tests:

  * ``lookup_numpy``  — host-side oracle; also what the cache's mutation
                        path (insert/evict/expire) uses to find slots;
  * ``lookup_torch``  — the plain PyTorch version (CPU tensors, and the
                        kernel's oracle on the card);
  * ``lookup_cuda``   — the hand-written kernel (``csrc/flow_lookup.cu``,
                        a group of lanes per query loading the whole
                        window at once, the first match by ballot).

``lookup_packed`` returns the three outputs as one (3, F) int32 tensor
(rows slot, pid, fresh as 0/1), which the kernel writes in place, so a
caller moves them to the host in one copy; ``lookup`` returns them as
three tensors. Both pick the kernel for CUDA tensors and the plain
version for CPU tensors. Keys are int64 flow ids split into two uint32
planes (lo, hi); the bucket hash is the same wraparound uint32 mix
everywhere. A slot is live iff its pid plane is >= 0. Outputs per query:

  slot  — int32 table slot holding the key (any epoch), or -1 if absent;
  pid   — int32 cached pipeline id if the entry is live AND epoch-fresh,
          else -1;
  fresh — bool, live key match with entry epoch == current epoch.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _u32

_M1 = np.uint32(0x9E3779B1)      # golden-ratio odd constants; wraparound
_M2 = np.uint32(0x85EBCA77)      # uint32 multiplies are identical in
_M3 = np.uint32(0xC2B2AE3D)      # numpy, PyTorch and CUDA.


# -- key splitting + bucket hash ---------------------------------------------

def split_fids(fids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 flow ids -> (lo, hi) uint32 planes (bit-exact round trip)."""
    u = np.asarray(fids, dtype=np.int64).view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def bucket_hash(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """uint32 mix of the two key words (numpy, wraps uint32 arithmetic)."""
    h = (lo * _M1) ^ (hi * _M2)
    h = (h ^ (h >> 15)) * _M3
    return h ^ (h >> 13)


def bucket_hash_torch(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The same mix on int64 tensors holding uint32 values; returns int64
    values in [0, 2^32)."""
    h = _u32.mul(lo, int(_M1)) ^ _u32.mul(hi, int(_M2))
    h = _u32.mul(h ^ (h >> 15), int(_M3))
    return h ^ (h >> 13)


# -- numpy oracle -------------------------------------------------------------

def lookup_numpy(key_lo: np.ndarray, key_hi: np.ndarray, pid: np.ndarray,
                 epoch: np.ndarray, q_lo: np.ndarray, q_hi: np.ndarray,
                 cur_epoch: int, window: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    cap = key_lo.shape[0]
    base = bucket_hash(q_lo, q_hi) & np.uint32(cap - 1)
    idx = ((base[:, None] + np.arange(window, dtype=np.uint32))
           & np.uint32(cap - 1)).astype(np.int64)              # (F, W)
    match = ((key_lo[idx] == q_lo[:, None])
             & (key_hi[idx] == q_hi[:, None]) & (pid[idx] >= 0))
    found = match.any(axis=1)
    first = match.argmax(axis=1)
    rows = np.arange(idx.shape[0])
    slot = np.where(found, idx[rows, first], -1).astype(np.int64)
    safe = np.where(slot >= 0, slot, 0)
    fresh = found & (epoch[safe] == np.int32(cur_epoch))
    out_pid = np.where(fresh, pid[safe], -1).astype(np.int32)
    return slot, out_pid, fresh


# -- plain PyTorch version ------------------------------------------------------

def lookup_torch(key_lo, key_hi, pid, epoch, q_lo, q_hi, cur_epoch: int,
                 window: int):
    cap = key_lo.shape[0]
    base = bucket_hash_torch(_u32.widen(q_lo), _u32.widen(q_hi)) & (cap - 1)
    offs = torch.arange(window, dtype=torch.int64, device=q_lo.device)
    idx = (base[:, None] + offs[None, :]) & (cap - 1)           # (F, W)
    klo, khi = key_lo.view(torch.int32), key_hi.view(torch.int32)
    qlo, qhi = q_lo.view(torch.int32), q_hi.view(torch.int32)
    match = ((klo[idx] == qlo[:, None]) & (khi[idx] == qhi[:, None])
             & (pid[idx] >= 0))
    found = match.any(dim=1)
    # argmax of an integer copy: the first maximum is the contract.
    first = match.to(torch.int32).argmax(dim=1)
    slot_w = idx.gather(1, first[:, None])[:, 0]
    slot = torch.where(found, slot_w, -1)
    safe = torch.where(slot >= 0, slot, 0)
    fresh = found & (epoch[safe] == cur_epoch)
    out_pid = torch.where(fresh, pid[safe], -1).to(torch.int32)
    return slot.to(torch.int32), out_pid, fresh


# -- CUDA kernel ----------------------------------------------------------------

def lookup_cuda(key_lo, key_hi, pid, epoch, q_lo, q_hi, cur_epoch: int,
                window: int) -> torch.Tensor:
    """Launch the kernel; returns the (3, F) int32 rows slot, pid, fresh."""
    name = "flow_lookup"
    dev = _build.require_cuda(name, key_lo, key_hi, pid, epoch, q_lo, q_hi)
    for what, t, dt in (("key_lo", key_lo, torch.uint32),
                        ("key_hi", key_hi, torch.uint32),
                        ("pid", pid, torch.int32),
                        ("epoch", epoch, torch.int32),
                        ("q_lo", q_lo, torch.uint32),
                        ("q_hi", q_hi, torch.uint32)):
        _build.require_dtype(name, what, t, dt)
    cap = key_lo.shape[0]
    F = q_lo.shape[0]
    if (cap & (cap - 1)) or any(t.shape != (cap,) for t in
                                (key_lo, key_hi, pid, epoch)):
        raise ValueError(f"{name}: the four planes must be (C,) with C a "
                         f"power of two")
    if q_hi.shape != (F,) or q_lo.dim() != 1 or not 1 <= window <= cap:
        raise ValueError(f"{name}: queries must be two (F,) planes and "
                         f"1 <= window <= C")
    out = torch.empty((3, F), dtype=torch.int32, device=dev)
    _build.launch(name, dev, key_lo.data_ptr(), key_hi.data_ptr(),
                  pid.data_ptr(), epoch.data_ptr(), cap, q_lo.data_ptr(),
                  q_hi.data_ptr(), F, int(cur_epoch), int(window),
                  out.data_ptr())
    return out


def pack(slot, pid, fresh) -> torch.Tensor:
    """(slot, pid, fresh) as the kernel's (3, F) int32 rows."""
    return torch.stack([slot, pid, fresh.to(torch.int32)])


def lookup_packed(key_lo, key_hi, pid, epoch, q_lo, q_hi, cur_epoch: int,
                  window: int) -> torch.Tensor:
    """(3, F) int32 rows slot, pid, fresh (0/1): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q_lo.is_cuda:
        return lookup_cuda(key_lo, key_hi, pid, epoch, q_lo, q_hi,
                           cur_epoch, window)
    return pack(*lookup_torch(key_lo, key_hi, pid, epoch, q_lo, q_hi,
                              cur_epoch, window))


def lookup(key_lo, key_hi, pid, epoch, q_lo, q_hi, cur_epoch: int,
           window: int):
    """(slot int32, pid int32, fresh bool): the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q_lo.is_cuda:
        out = lookup_cuda(key_lo, key_hi, pid, epoch, q_lo, q_hi, cur_epoch,
                          window)
        return out[0], out[1], out[2].bool()
    return lookup_torch(key_lo, key_hi, pid, epoch, q_lo, q_hi, cur_epoch,
                        window)


# -- incremental device-table maintenance -------------------------------------

def apply_updates(planes: Sequence[torch.Tensor], slots, u_lo, u_hi, u_pid,
                  u_epoch) -> Tuple[torch.Tensor, ...]:
    """Scatter host-side table mutations into the device-resident planes.

    ``planes`` is the (key_lo, key_hi, pid, epoch) tuple of tensors, updated
    in place (the cache owns them and replaces its mirror with the result,
    where the reference returns fresh arrays). Host arrays in; ``slots`` may
    be padded with values >= capacity, which are dropped, as the reference's
    ``mode="drop"`` scatter does.
    """
    cap = planes[0].shape[0]
    slots = np.asarray(slots, np.int64)
    keep = slots < cap
    dev = planes[0].device
    idx = torch.from_numpy(slots[keep]).to(dev)
    for plane, vals in zip(planes, (u_lo, u_hi, u_pid, u_epoch)):
        np_dt = np.uint32 if plane.dtype == torch.uint32 else np.int32
        vals = np.asarray(vals)[keep].astype(np_dt)
        plane.view(torch.int32)[idx] = (
            torch.from_numpy(vals).view(torch.int32).to(dev))
    return tuple(planes)
