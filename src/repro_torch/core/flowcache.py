"""Device-resident exact-match flow cache — the megaflow fast path.

The OVS hardware-offload split, reproduced for the Traffic Orchestrator: the
FIRST packet batch of a flow takes the slow path (the full §5.1.2 placement
decision in ``TrafficOrchestrator.partition_assign``) and every later batch
hits this exact-match table, so steady-state per-batch control cost is
O(cache misses), not O(unique flows).

Structure: an open-addressed fid -> (pipeline, epoch) table with bounded
probe windows (``kernels.flow_lookup`` holds the probe math and the lookup
versions). The host planes are numpy and authoritative; they are mirrored
as tensors on ``device``. Batch lookups run there (the CUDA kernel on the
card, the plain PyTorch version on the CPU), and host-side mutations —
inserts, refreshes, deletions — are streamed to the device as bucketed
scatter updates, so a pure-hit steady state moves nothing host->device.

Consistency is by *epoch*, not by scanning: any control-plane action that
can re-home flows (migration begin/finish, pipeline halt, failover) bumps
``epoch``; a lookup whose entry carries an older epoch is reported as a key
match but NOT fresh, so the orchestrator revalidates that flow once through
the slow path and refreshes the entry in place. Eviction is seeded-clock
second chance: a hit sets the slot's reference bit; an insert into a full
window first spends reference bits, then evicts the oldest stamp, with a
seeded per-slot jitter (numpy ``default_rng``, the reference's stream)
breaking stamp ties, so runs are bit-reproducible.

Recency (``stamp``) doubles as the idle-expiry signal that bounds BOTH the
cache and the orchestrator's ``flow_table``/``spill_table`` dicts. The cache
stores only each flow's HOME pipeline; capacity validation against the live
pipeline set happens per batch in the orchestrator.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.hw import resolve_device
from repro_torch.kernels import flow_lookup as fl


def _pow2(n: int) -> int:
    return 1 << max(4, int(n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class FlowCacheConfig:
    capacity: int = 1 << 17        # slots (rounded up to a power of two)
    window: int = 8                # bounded probe window (slots per key)
    idle_ttl: int = 4096           # rounds before an untouched entry expires
    expire_every: int = 256        # rounds between idle-expiry sweeps
    seed: int = 0                  # clock-eviction tie-break seed
    enabled: bool = True           # False: recency ledger only, no fast path


class FlowCache:
    """fid -> (home pipeline, epoch) with recency stamps and clock bits."""

    def __init__(self, config: Optional[FlowCacheConfig] = None,
                 device="cuda", **kw):
        self.cfg = config or FlowCacheConfig(**kw)
        self.device = resolve_device(device)
        cap = _pow2(self.cfg.capacity)
        self.capacity = cap
        self.window = int(self.cfg.window)
        if not 1 <= self.window <= cap:
            raise ValueError(f"window {self.window} must be in [1, {cap}]")
        self.epoch = 0
        # Host-authoritative planes. pid < 0 == empty slot.
        self.key_lo = np.zeros(cap, np.uint32)
        self.key_hi = np.zeros(cap, np.uint32)
        self.pid = np.full(cap, -1, np.int32)
        self.ep = np.zeros(cap, np.int32)
        self.stamp = np.zeros(cap, np.int64)     # last-touch round
        self.ref = np.zeros(cap, np.uint8)       # second-chance bit
        # Seeded tie-break for clock eviction among equal stamps.
        self._tie = np.random.default_rng(self.cfg.seed).random(cap)
        # Device mirror of the lookup planes (key_lo/key_hi/pid/ep). Host
        # mutations accumulate in _pending (slot indices) and are flushed as
        # one bucketed scatter before the next device lookup; stamps/refs
        # never leave the host (the kernel does not read them).
        self._planes: Optional[Tuple] = None
        self._pending: list = []
        self._full_upload = True
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "evictions": 0, "invalidations": 0,
            "expirations": 0, "inserts": 0, "refreshes": 0, "fallbacks": 0,
            "lookups": 0, "uploads": 0, "scatter_updates": 0,
        }

    # -- epoch ----------------------------------------------------------------
    def invalidate(self, reason: str = "") -> None:
        """Bump the epoch: every cached entry becomes stale at once (O(1));
        each flow revalidates through the slow path on its next appearance."""
        self.epoch += 1
        self.stats["invalidations"] += 1

    # -- lookup ----------------------------------------------------------------
    def lookup(self, fids: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch probe. Returns (slot, pid, fresh): ``slot`` is the table
        slot holding the key at ANY epoch (-1 absent) — the in-place refresh
        handle; ``pid``/``fresh`` report an epoch-current hit."""
        fids = np.asarray(fids, np.int64)
        self.stats["lookups"] += int(fids.size)
        lo, hi = fl.split_fids(fids)
        if fids.size == 0:
            return fl.lookup_numpy(self.key_lo, self.key_hi, self.pid,
                                   self.ep, lo, hi, self.epoch, self.window)
        planes = self._device_planes()
        F = fids.size
        Fp = _pow2(F)
        if Fp != F:
            lo = np.concatenate([lo, np.zeros(Fp - F, np.uint32)])
            hi = np.concatenate([hi, np.zeros(Fp - F, np.uint32)])
        qlo = torch.from_numpy(lo).to(self.device)
        qhi = torch.from_numpy(hi).to(self.device)
        # the kernel writes the three outputs as one (3, F) buffer: one
        # device->host copy
        out = fl.lookup_packed(*planes, qlo, qhi, self.epoch,
                               window=self.window).cpu().numpy()
        return (out[0, :F].astype(np.int64), out[1, :F],
                out[2, :F].astype(bool))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.copy()).to(self.device)

    def _device_planes(self) -> Tuple:
        if self._planes is None or self._full_upload:
            self._planes = (self._upload(self.key_lo),
                            self._upload(self.key_hi),
                            self._upload(self.pid), self._upload(self.ep))
            self._full_upload = False
            self._pending.clear()
            self.stats["uploads"] += 1
        elif self._pending:
            slots = np.unique(np.concatenate(self._pending))
            n = slots.size
            npad = _pow2(n)
            pad = np.full(npad - n, self.capacity, np.int64)  # dropped
            s = np.concatenate([slots, pad])
            safe = np.concatenate([slots, np.zeros(npad - n, np.int64)])
            self._planes = fl.apply_updates(
                self._planes, s, self.key_lo[safe], self.key_hi[safe],
                self.pid[safe], self.ep[safe])
            self._pending.clear()
            self.stats["scatter_updates"] += 1
        return self._planes

    def _mark(self, slots: np.ndarray) -> None:
        if slots.size:
            if len(self._pending) > 64:          # coalesce long mutation runs
                self._pending = [np.unique(np.concatenate(self._pending))]
            self._pending.append(np.asarray(slots, np.int64))

    # -- mutation --------------------------------------------------------------
    def touch(self, slots: np.ndarray, round_: int) -> None:
        """LRU touch on assignment: hits refresh recency + reference bit.
        Host-only state — no device traffic in a pure-hit steady state."""
        slots = np.asarray(slots, np.int64)
        slots = slots[slots >= 0]
        if slots.size:
            self.stamp[slots] = round_
            self.ref[slots] = 1

    def refresh(self, slots: np.ndarray, pids: np.ndarray,
                round_: int) -> None:
        """Revalidate matched-but-stale entries in place (post epoch bump)."""
        slots = np.asarray(slots, np.int64)
        keep = slots >= 0
        slots, pids = slots[keep], np.asarray(pids, np.int32)[keep]
        if not slots.size:
            return
        self.pid[slots] = pids
        self.ep[slots] = self.epoch
        self.stamp[slots] = round_
        self.ref[slots] = 1
        self.stats["refreshes"] += int(slots.size)
        self._mark(slots)

    def insert(self, fids: np.ndarray, pids: np.ndarray, round_: int) -> None:
        """Insert new keys (callers pass keys ``lookup`` reported absent).

        Vectorized first-empty-slot placement; keys whose chosen slot
        conflicts (two new keys, one empty slot) or whose window is full
        fall back to the per-key clock-eviction path."""
        fids = np.asarray(fids, np.int64)
        pids = np.asarray(pids, np.int32)
        if not fids.size:
            return
        lo, hi = fl.split_fids(fids)
        mask = np.uint32(self.capacity - 1)
        base = fl.bucket_hash(lo, hi) & mask
        win = ((base[:, None] + np.arange(self.window, dtype=np.uint32))
               & mask).astype(np.int64)                       # (n, W)
        empty = self.pid[win] < 0
        has_empty = empty.any(axis=1)
        choice = win[np.arange(win.shape[0]), empty.argmax(axis=1)]
        # First claimant per slot wins the vector path; the rest loop.
        _, first_idx = np.unique(choice, return_index=True)
        ok = np.zeros(fids.size, bool)
        ok[first_idx] = True
        ok &= has_empty
        tgt = choice[ok]
        self.key_lo[tgt] = lo[ok]
        self.key_hi[tgt] = hi[ok]
        self.pid[tgt] = pids[ok]
        self.ep[tgt] = self.epoch
        self.stamp[tgt] = round_
        self.ref[tgt] = 1
        self.stats["inserts"] += int(tgt.size)
        self._mark(tgt)
        for i in np.nonzero(~ok)[0]:
            self._insert_one(int(win[i][0]), win[i], lo[i], hi[i],
                             int(pids[i]), round_)

    def _insert_one(self, _base: int, win: np.ndarray, lo: np.uint32,
                    hi: np.uint32, pid: int, round_: int) -> None:
        empty = np.nonzero(self.pid[win] < 0)[0]
        if empty.size:
            slot = int(win[empty[0]])
        else:
            # Seeded-clock second chance: referenced entries spend their bit
            # and survive this round; the victim is the oldest unreferenced
            # stamp (seeded jitter breaks ties deterministically).
            cand = np.nonzero(self.ref[win] == 0)[0]
            if cand.size == 0:
                self.ref[win] = 0                 # clock hand sweeps the window
                cand = np.arange(win.size)
            w = win[cand]
            victim = cand[np.lexsort((self._tie[w], self.stamp[w]))[0]]
            slot = int(win[victim])
            self.stats["evictions"] += 1
        self.key_lo[slot] = lo
        self.key_hi[slot] = hi
        self.pid[slot] = pid
        self.ep[slot] = self.epoch
        self.stamp[slot] = round_
        self.ref[slot] = 1
        self.stats["inserts"] += 1
        self._mark(np.array([slot], np.int64))

    def record(self, fids: np.ndarray, pids: np.ndarray, round_: int) -> None:
        """Post-slow-path bookkeeping: touch/refresh present keys, insert
        absent ones — one numpy probe, O(misses) insert work."""
        fids = np.asarray(fids, np.int64)
        if not fids.size:
            return
        pids = np.asarray(pids, np.int32)
        lo, hi = fl.split_fids(fids)
        slot, _, fresh = fl.lookup_numpy(self.key_lo, self.key_hi, self.pid,
                                         self.ep, lo, hi, self.epoch,
                                         self.window)
        present = slot >= 0
        stale = present & ~fresh
        self.touch(slot[present], round_)
        # Present entries are refreshed when stale OR re-homed (pid drift
        # without an epoch bump cannot happen for cached assignments, but
        # the slow path is authoritative — mirror whatever it decided).
        moved = present & (self.pid[np.where(present, slot, 0)] != pids)
        upd = stale | moved
        if upd.any():
            self.refresh(slot[upd], pids[upd], round_)
        absent = ~present
        if absent.any():
            self.insert(fids[absent], pids[absent], round_)

    def delete(self, fids: np.ndarray) -> int:
        """Drop entries for ``fids`` (used by table pruning so the cache
        never resurrects a flow the orchestrator forgot)."""
        fids = np.asarray(fids, np.int64)
        if not fids.size:
            return 0
        lo, hi = fl.split_fids(fids)
        slot, _, _ = fl.lookup_numpy(self.key_lo, self.key_hi, self.pid,
                                     self.ep, lo, hi, self.epoch, self.window)
        slots = slot[slot >= 0]
        if slots.size:
            self.pid[slots] = -1
            self._mark(slots)
        return int(slots.size)

    def expire_idle(self, round_: int) -> int:
        """Clear entries untouched for ``idle_ttl`` rounds (one vectorized
        sweep, amortized by ``expire_every``)."""
        ttl = self.cfg.idle_ttl
        old = np.nonzero((self.pid >= 0) & (self.stamp < round_ - ttl))[0]
        if old.size:
            self.pid[old] = -1
            self.stats["expirations"] += int(old.size)
            self._mark(old)
        return int(old.size)

    # -- introspection ---------------------------------------------------------
    def last_seen(self, fids: np.ndarray) -> np.ndarray:
        """Recency stamp per fid, -1 when the flow has no live entry."""
        fids = np.asarray(fids, np.int64)
        if not fids.size:
            return np.zeros(0, np.int64)
        lo, hi = fl.split_fids(fids)
        slot, _, _ = fl.lookup_numpy(self.key_lo, self.key_hi, self.pid,
                                     self.ep, lo, hi, self.epoch, self.window)
        return np.where(slot >= 0, self.stamp[np.where(slot >= 0, slot, 0)],
                        -1).astype(np.int64)

    def occupancy(self) -> int:
        return int((self.pid >= 0).sum())

    def stats_snapshot(self) -> Dict[str, int]:
        return dict(self.stats, occupancy=self.occupancy(), epoch=self.epoch)

    def check_device_mirror(self) -> bool:
        """Test hook: the device planes must equal the host planes after a
        flush (incremental scatters may not drift)."""
        if self._planes is None:
            return True
        planes = self._device_planes()
        host = (self.key_lo, self.key_hi, self.pid, self.ep)
        return all(np.array_equal(d.cpu().numpy(), h)
                   for d, h in zip(planes, host))
