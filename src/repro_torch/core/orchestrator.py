"""Per-application Traffic Orchestrator (paper §5.1.2, §5.2).

The TO runs on a host core (paper: one reserved ARM core per NIC) and manages
the application's replicated pipelines:

  * a **flow table** mapping flow-id -> pipeline-id plus per-pipeline load;
  * **flow-granular partitioning**: packets of an existing flow stick to its
    pipeline; a heavy flow spills to additional pipelines only once its
    current pipeline hits its per-round capacity; new flows go to the
    pipeline with the highest available capacity;
  * **sequence-numbered aggregation**: each sub-batch carries a unique
    sequence number; egress batches are reordered so the application observes
    the original packet order;
  * **lazy flow state migration** between pipelines during adaptive scaling.

Control decisions are host-side numpy — exactly where they run in the paper
(the TO owns one reserved ARM core, so its work must stay cheap). The
partition code is the JAX package's, line for line: flow-granular and
vectorized, flows served in first-appearance order (flow-major, not
packet-interleaved; under saturation the two pick different spill victims).
Only ``flow_ids``, ``take_batch`` and ``aggregate`` touch tensors: the
5-tuple comes to the host once per batch, and packet gathers stay on the
batch's device. ``trace`` is duck-typed (any object with ``event``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.graph import PacketBatch, bits, take, tree_map

# Sentinel values in the per-packet assign array.
ASSIGN_NONE = -1      # not yet assigned (internal)
ASSIGN_HALTED = -2    # buffered behind a migrating flow

# Max per-flow ``slow_path_place`` trace events per batch (sampled; an
# aggregate ``flow_cache_batch`` event always carries the totals).
PLACE_TRACE_CAP = 32


def flow_ids(batch: PacketBatch) -> np.ndarray:
    """Stable per-packet flow id from the 5-tuple (host-side)."""
    ft = batch.five_tuple.cpu().numpy().astype(np.int64)
    h = ft[:, 0] * 1000003 + ft[:, 1] * 10007 + ft[:, 2] * 101 + ft[:, 3] * 13 + ft[:, 4]
    return h


def take_batch(batch: PacketBatch, idx) -> PacketBatch:
    """Gather a sub-batch on the batch's device (``idx``: host indices or
    a tensor)."""
    idx = torch.as_tensor(idx, dtype=torch.int64).to(batch.device)
    return tree_map(lambda a: take(a, idx), batch)


@dataclasses.dataclass
class SubBatch:
    """One partitioned unit: pipeline id, sequence number, original indices."""

    pid: int
    seq: int
    indices: np.ndarray          # positions in the source batch
    data: PacketBatch


@dataclasses.dataclass
class PipelineStatus:
    pid: int
    capacity: float              # packets per partition round
    load: float = 0.0            # packets assigned this round
    active: bool = True

    @property
    def available(self) -> float:
        return max(0.0, self.capacity - self.load) if self.active else 0.0


class TrafficOrchestrator:
    def __init__(self, num_pipelines: int, capacity_per_pipeline: float,
                 flow_cache=None, table_cap: int | None = None, trace=None):
        self.pipelines: List[PipelineStatus] = [
            PipelineStatus(pid=i, capacity=capacity_per_pipeline)
            for i in range(num_pipelines)
        ]
        self.flow_table: Dict[int, int] = {}
        self.spill_table: Dict[int, List[int]] = {}         # heavy-flow extras
        self.halted_flows: Dict[int, List[SubBatch]] = {}   # migration buffers
        self._seq = 0
        # Megaflow fast path (core.flowcache.FlowCache, or None = slow-only).
        # The cache is an accelerator, never an authority: a batch is served
        # from it only when the hits provably reproduce the slow path
        # (see _fast_assign), otherwise the whole batch falls back.
        self.flow_cache = flow_cache
        self.table_cap = table_cap            # bound on len(flow_table)
        self.trace = trace                    # obs.DecisionTrace or None
        self._round = 0                       # assignment rounds (LRU clock)
        self.fast_stats: Dict[str, int] = {
            "fast_batches": 0, "slow_batches": 0, "fallbacks": 0,
            "hit_flows": 0, "miss_flows": 0, "hit_pkts": 0, "miss_pkts": 0,
            "pruned": 0, "expired": 0,
        }

    # -- §5.1.2 traffic partitioning ------------------------------------------
    def partition_assign(self, batch: PacketBatch,
                         tenant: str | None = None) -> np.ndarray:
        """Vectorized flow-granular assignment for one ingress batch.

        Returns the per-packet ``assign`` array: pipeline id per packet, or
        ``ASSIGN_HALTED`` for packets of a migrating flow (those are gathered
        into the TO's side buffer before returning). Decisions are computed
        once per *flow*; per-packet work is numpy scatter only.

        With a ``flow_cache`` attached, flows with a fresh cache entry skip
        the decision loop entirely (megaflow fast path): one device lookup
        classifies the batch and only cache *misses* run the slow loop below.
        The fast path is byte-identical to the slow path — it validates that
        every cache hit would have been served fully by its home pipeline at
        its turn, and falls back to a pristine slow run otherwise.

        Per-flow allocation order (equals one-packet-at-a-time §5.1.2):
          1. the flow's home pipeline, while it has available capacity;
          2. the flow's existing spill pipelines, in spill order;
          3. repeatedly, the active pipeline with the highest available
             capacity (recorded as a new spill for a homed flow, or as the
             home for a new flow);
          4. if every active pipeline is saturated, the remainder overloads
             the highest-capacity active pipeline (load tracks the overload
             so ``utilization`` sees it).
        """
        fids = flow_ids(batch)
        B = len(fids)
        self._round += 1
        for p in self.pipelines:
            p.load = 0.0
        assign = np.full(B, ASSIGN_NONE, dtype=np.int64)
        if B == 0:
            return assign

        uniq, first_pos, inverse, counts = np.unique(
            fids, return_index=True, return_inverse=True, return_counts=True)

        cache = self.flow_cache
        done = False
        if cache is not None and cache.cfg.enabled:
            # The fast path groups only miss-flow packets itself, so the
            # full-batch argsort below is skipped on the hot path entirely.
            done = self._fast_assign(assign, uniq, first_pos, inverse,
                                     counts, tenant)
        if not done:
            by_flow = np.argsort(inverse, kind="stable")  # grouped, in order
            group_start = np.concatenate([[0], np.cumsum(counts)])
            if cache is not None:
                self.fast_stats["slow_batches"] += 1
            self._slow_assign(assign, uniq, first_pos, by_flow, group_start,
                              tenant)
            if cache is not None:
                self._record_slow(assign, uniq, by_flow, group_start)
        self._maintain()

        # Buffer packets of halted (migrating) flows (scan only the halted
        # subset, not the batch, once per flow).
        hidx = np.nonzero(assign == ASSIGN_HALTED)[0]
        if hidx.size:
            hfids = fids[hidx]
            for f in np.unique(hfids):
                sel = hidx[hfids == f]
                self.halted_flows[int(f)].append(
                    SubBatch(pid=-1, seq=self._seq, indices=sel,
                             data=take_batch(batch, sel)))
                self._seq += 1
        return assign

    def _slow_assign(self, assign: np.ndarray, uniq: np.ndarray,
                     first_pos: np.ndarray, by_flow: np.ndarray,
                     group_start: np.ndarray,
                     tenant: str | None = None) -> None:
        """The full §5.1.2 decision loop over every unique flow (in-place on
        ``assign``). This is the authority the fast path defers to."""
        npipe = len(self.pipelines)
        cap = np.array([p.capacity for p in self.pipelines], np.float64)
        active = np.array([p.active for p in self.pipelines], bool)
        avail = np.where(active, cap, 0.0)
        load = np.zeros(npipe, np.float64)
        traced = 0

        def grab(pid: int, seg: np.ndarray, off: int) -> int:
            """Assign as many of seg[off:] to pid as its capacity allows."""
            if avail[pid] < 1.0:
                return off
            take = min(seg.size - off, int(avail[pid]))
            assign[seg[off:off + take]] = pid
            avail[pid] -= take
            load[pid] += take
            return off + take

        # Flows in first-appearance order — the order the per-packet walk
        # would discover them.
        for u in np.argsort(first_pos, kind="stable"):
            f = int(uniq[u])
            seg = by_flow[group_start[u]:group_start[u + 1]]
            if f in self.halted_flows:
                assign[seg] = ASSIGN_HALTED
                continue
            # Raised lazily: a batch made entirely of halted-flow packets
            # must buffer cleanly even with every pipeline scaled down.
            if not active.any():
                raise ValueError("partition: no active pipelines")
            home = self.flow_table.get(f)
            was_new = home is None
            off = 0
            if home is not None and active[home]:
                off = grab(home, seg, off)
            if off < seg.size:
                for spid in self.spill_table.get(f, ()):
                    if active[spid]:
                        off = grab(spid, seg, off)
                    if off == seg.size:
                        break
            while off < seg.size:
                pid = int(np.argmax(np.where(active, avail, -1.0)))
                if avail[pid] >= 1.0:
                    off = grab(pid, seg, off)
                else:
                    # Every active pipeline saturated: overload the largest.
                    pid = int(np.argmax(np.where(active, cap, -1.0)))
                    assign[seg[off:]] = pid
                    load[pid] += seg.size - off
                    off = seg.size
                if home is None:
                    self.flow_table[f] = pid   # first pipeline stays "home"
                    home = pid
                elif pid != home:
                    sp = self.spill_table.setdefault(f, [])
                    if pid not in sp:
                        sp.append(pid)
            if was_new and self.trace is not None and traced < PLACE_TRACE_CAP:
                traced += 1
                self.trace.event("slow_path_place", tenant=tenant,
                                 flow=f, pipeline=int(home),
                                 reason="new_flow")

        for p, l in zip(self.pipelines, load):
            p.load = float(l)

    # -- megaflow fast path ------------------------------------------------------
    def _fast_assign(self, assign: np.ndarray, uniq: np.ndarray,
                     first_pos: np.ndarray, inverse: np.ndarray,
                     counts: np.ndarray,
                     tenant: str | None) -> bool:
        """Serve one batch from the flow cache; returns False to demand a
        pristine slow-path run instead (nothing committed in that case).

        A cache *hit* (fresh entry, live + active home pipeline, flow not
        halted) charges the flow's full packet count to its home. Misses run
        a position-exact replica of the slow loop: the availability each miss
        sees is ``cap − (hit charges from flows appearing earlier) − (grabs
        from earlier misses)``, which is what the interleaved slow walk would
        see *provided every hit was fully served by its home at its own turn*.
        That proviso is checked after the loop — for each pipeline, total
        non-overload grabs (hit + miss) must fit its capacity; if any hit
        could have spilled, the batch is re-run through `_slow_assign`
        untouched. Flow-table/spill mutations stage in pending dicts and
        commit only on success, so fallback is side-effect free.
        """
        cache = self.flow_cache
        npipe = len(self.pipelines)
        cap = np.array([p.capacity for p in self.pipelines], np.float64)
        active = np.array([p.active for p in self.pipelines], bool)
        F = uniq.size

        if self.halted_flows:
            hkeys = np.fromiter(self.halted_flows.keys(), np.int64,
                                len(self.halted_flows))
            halted = np.isin(uniq, hkeys)
        else:
            halted = np.zeros(F, bool)
        if not active.any():
            if (~halted).any():
                return False          # slow path raises the canonical error
            assign[:] = ASSIGN_HALTED
            self.fast_stats["fast_batches"] += 1
            return True

        slot, cpid, fresh = cache.lookup(uniq)
        in_range = (cpid >= 0) & (cpid < npipe)
        safe = np.where(in_range, cpid, 0)
        hit = fresh & in_range & active[safe] & ~halted
        miss = ~hit & ~halted
        hsel = np.nonzero(hit)[0]

        # Scatter hits + halted to packets in one gather; misses stay
        # ASSIGN_NONE until the loop below fills them.
        upid = np.full(F, np.int64(ASSIGN_NONE))
        upid[halted] = ASSIGN_HALTED
        upid[hit] = cpid[hit]
        assign[:] = upid[inverse]

        # Misses in first-appearance order — sort only the miss subset, not
        # every flow in the batch (first_pos values are distinct, so sorting
        # the subset equals filtering the full argsort).
        mu = np.flatnonzero(miss)              # miss flows, ascending uniq idx
        morder = mu[np.argsort(first_pos[mu], kind="stable")]
        M = morder.size
        mpos = first_pos[morder]

        # Per-flow packet segments for MISS flows only (the hot path never
        # argsorts the whole batch): gather miss packets, group by flow.
        psel = np.flatnonzero(miss[inverse])   # their packets, arrival order
        mseq = psel[np.argsort(inverse[psel], kind="stable")]
        mstart = np.concatenate([[0], np.cumsum(counts[mu])])
        mrank = np.searchsorted(mu, morder)    # uniq idx -> row in mstart

        # Hit charges bucketed by which miss they precede: a hit at position
        # h lands in bucket searchsorted(mpos, h) = number of misses before
        # it, so cumsum row k = every hit charge visible to miss k. Counts
        # are integral so the bincount sum is exact (no FP order effects).
        if hsel.size:
            interval = np.searchsorted(mpos, first_pos[hsel])
            seg_charge = np.bincount(
                interval * npipe + cpid[hsel],
                weights=counts[hsel].astype(np.float64),
                minlength=(M + 1) * npipe).reshape(M + 1, npipe)
        else:
            seg_charge = np.zeros((M + 1, npipe), np.float64)
        hit_prefix = np.cumsum(seg_charge, axis=0)
        hit_charge = hit_prefix[M]

        # The replica loop runs on native Python scalars (identical float64
        # arithmetic, ~3x less per-miss overhead than 8-wide numpy temps).
        # Python max() and np.argmax agree on ties: both keep the first max.
        cap_l = cap.tolist()
        active_l = active.tolist()
        hp_l = hit_prefix.tolist()
        taken_l = [0.0] * npipe
        over_l = [0.0] * npipe
        pend_home: Dict[int, int] = {}
        pend_spill: Dict[int, List[int]] = {}
        miss_homes = np.empty(M, np.int64)
        miss_clean = np.zeros(M, bool)         # cacheable: single-pipeline
        places: List = []                      # sampled trace tuples
        mfids = uniq[morder].tolist()
        mrank_l = mrank.tolist()
        ft_get = self.flow_table.get
        sp_get = self.spill_table.get
        pipe_rng = range(npipe)
        want_trace = self.trace is not None

        for k in range(M):
            f = mfids[k]
            r = mrank_l[k]
            seg = mseq[mstart[r]:mstart[r + 1]]
            nseg = seg.size
            hpk = hp_l[k]
            avail = [cap_l[i] - hpk[i] - taken_l[i] if active_l[i] else
                     -hpk[i] - taken_l[i] for i in pipe_rng]
            home = ft_get(f)
            was_new = home is None
            off = 0
            clean = True

            def grab(pid: int, off: int) -> int:
                a = avail[pid]
                if a < 1.0:
                    return off
                take = min(nseg - off, int(a))
                assign[seg[off:off + take]] = pid
                taken_l[pid] += take
                avail[pid] = a - take
                return off + take

            if home is not None and active_l[home]:
                off = grab(home, off)
            if off < nseg:
                for spid in sp_get(f, ()):
                    if active_l[spid]:
                        noff = grab(spid, off)
                        if noff != off:
                            clean = False
                            off = noff
                    if off == nseg:
                        break
            while off < nseg:
                pid = max(pipe_rng,
                          key=lambda i: avail[i] if active_l[i] else -1.0)
                if avail[pid] >= 1.0:
                    off = grab(pid, off)
                else:
                    pid = max(pipe_rng,
                              key=lambda i: cap_l[i] if active_l[i] else -1.0)
                    assign[seg[off:]] = pid
                    over_l[pid] += nseg - off
                    off = nseg
                if home is None:
                    pend_home[f] = pid
                    home = pid
                elif pid != home:
                    clean = False
                    sp = pend_spill.get(f)
                    if sp is None:
                        sp = pend_spill[f] = list(sp_get(f, ()))
                    if pid not in sp:
                        sp.append(pid)
            miss_homes[k] = home
            # Cache only flows served entirely by one pipeline (their home):
            # a heavy spiller must NOT become a hit — charging it all to home
            # would force a fallback every batch. Left uncached it stays a
            # miss and the replica loop spills it exactly like the slow path.
            # ``clean`` tracked inline == (assign[seg] == home).all(): every
            # packet lands via grab(home)/first-grab-of-a-new-flow unless a
            # spill/argmax/overload branch assigned some other pipeline.
            miss_clean[k] = clean
            if want_trace and len(places) < PLACE_TRACE_CAP:
                u = morder[k]
                if slot[u] < 0:
                    reason = "new_flow" if was_new else "cache_evicted"
                elif not fresh[u]:
                    reason = "stale_epoch"
                else:
                    reason = "inactive_home"
                places.append((f, int(home), reason))

        taken = np.array(taken_l, np.float64)
        over = np.array(over_l, np.float64)
        ok = bool(np.all(hit_charge + taken <= cap))
        if not ok:
            # Some hit would have spilled at its turn: the cached answer is
            # not the slow-path answer. Discard everything.
            assign[:] = ASSIGN_NONE
            self.fast_stats["fallbacks"] += 1
            cache.stats["fallbacks"] += 1
            if self.trace is not None:
                self.trace.event("fast_path_fallback", tenant=tenant,
                                 flows=int(F), hits=int(hsel.size),
                                 reason="hit_overcommit")
            return False

        self.flow_table.update(pend_home)
        for f, sp in pend_spill.items():
            self.spill_table[f] = sp
        load = hit_charge + taken + over
        for p, l in zip(self.pipelines, load):
            p.load = float(l)

        cache.touch(slot[hsel], self._round)
        if miss_clean.any():
            cache.record(uniq[morder[miss_clean]], miss_homes[miss_clean],
                         self._round)
        cache.stats["hits"] += int(hsel.size)
        cache.stats["misses"] += int(M)
        fs = self.fast_stats
        fs["fast_batches"] += 1
        fs["hit_flows"] += int(hsel.size)
        fs["miss_flows"] += int(M)
        fs["hit_pkts"] += int(counts[hsel].sum())
        fs["miss_pkts"] += int(counts[morder].sum())
        if self.trace is not None:
            for f, pid, reason in places:
                self.trace.event("slow_path_place", tenant=tenant, flow=f,
                                 pipeline=pid, reason=reason)
            self.trace.event("flow_cache_batch", tenant=tenant,
                             flows=int(F), hits=int(hsel.size),
                             misses=int(M), halted=int(halted.sum()))
        return True

    def _record_slow(self, assign: np.ndarray, uniq: np.ndarray,
                     by_flow: np.ndarray, group_start: np.ndarray) -> None:
        """Mirror slow-path decisions into the cache (cold/fallback batches).

        Only flows whose whole segment landed on a single pipeline — their
        home — are cached (same single-pipeline rule as the fast path:
        spillers must stay misses or they would poison every later batch
        with hit-overcommit fallbacks). One vectorized reduceat, no loop."""
        grouped = assign[by_flow]
        starts = group_start[:-1].astype(np.int64)
        mn = np.minimum.reduceat(grouped, starts)
        mx = np.maximum.reduceat(grouped, starts)
        uniform = (mn == mx) & (mn >= 0)
        if not uniform.any():
            return
        keys = uniq[uniform]
        homes = mn[uniform]
        tab = np.array([self.flow_table.get(int(f), -1) for f in keys],
                       np.int64)
        sel = tab == homes
        if sel.any():
            self.flow_cache.record(keys[sel], homes[sel], self._round)

    def _maintain(self) -> None:
        """Amortized state bounding: cache idle expiry every
        ``expire_every`` rounds; flow/spill-table pruning past ``table_cap``
        (coldest cache stamp first, halted flows always kept)."""
        cache = self.flow_cache
        if cache is None:
            return
        every = cache.cfg.expire_every
        if every > 0 and self._round % every == 0:
            self.fast_stats["expired"] += cache.expire_idle(self._round)
        if self.table_cap is not None and len(self.flow_table) > self.table_cap:
            self._prune_tables()

    def _prune_tables(self) -> None:
        cache = self.flow_cache
        keys = np.fromiter(self.flow_table.keys(), np.int64,
                           len(self.flow_table))
        seen = cache.last_seen(keys)    # -1 when evicted/expired from cache
        if self.halted_flows:
            hk = np.fromiter(self.halted_flows.keys(), np.int64,
                             len(self.halted_flows))
            seen[np.isin(keys, hk)] = np.iinfo(np.int64).max  # never pruned
        ndrop = len(self.flow_table) - self.table_cap
        order = np.argsort(seen, kind="stable")
        order = order[seen[order] < np.iinfo(np.int64).max][:ndrop]
        drop = keys[order]
        for f in drop.tolist():
            self.flow_table.pop(f, None)
            self.spill_table.pop(f, None)
        cache.delete(drop)
        self.fast_stats["pruned"] += int(drop.size)
        if self.trace is not None:
            self.trace.event("flow_table_prune", dropped=int(drop.size),
                             kept=len(self.flow_table))

    def partition(self, batch: PacketBatch) -> List[SubBatch]:
        """Split an ingress batch across pipelines, flow-granular.

        Compatibility view over :meth:`partition_assign`: materializes one
        SubBatch per non-empty pipeline (device gather per sub-batch). The
        fused data plane (``core.executor.ParallelDataPlane``) skips this and
        consumes the assign array directly.
        """
        assign = self.partition_assign(batch)
        subs: List[SubBatch] = []
        for pid in range(len(self.pipelines)):
            idx = np.nonzero(assign == pid)[0]
            if idx.size == 0:
                continue
            subs.append(SubBatch(pid=pid, seq=self._seq,
                                 indices=idx,
                                 data=take_batch(batch, idx)))
            self._seq += 1
        return subs

    # -- §5.1.2 aggregation -----------------------------------------------------
    @staticmethod
    def aggregate(subs: Sequence[SubBatch], total: int) -> PacketBatch:
        """Reorder processed sub-batches back to original packet order."""
        subs = sorted(subs, key=lambda s: s.seq)
        all_idx = np.concatenate([s.indices for s in subs])
        inv = np.empty(total, dtype=np.int64)
        if all_idx.size != total:
            raise ValueError(f"aggregate: {all_idx.size} packets != batch {total}")
        inv[all_idx] = np.arange(total)
        cat = tree_map(lambda *xs: torch.cat([bits(x) for x in xs],
                                             dim=0).view(xs[0].dtype),
                       *[s.data for s in subs])
        return take_batch(cat, inv)

    # -- §5.2 flow state migration ----------------------------------------------
    def _invalidate_cache(self, reason: str) -> None:
        if self.flow_cache is not None:
            self.flow_cache.invalidate(reason)

    def begin_migration(self, flow: int) -> None:
        """Halt a flow: subsequent packets buffer in the TO's side ring."""
        self.halted_flows.setdefault(flow, [])
        # The halted check masks cached entries already; the bump is the
        # §tentpole epoch discipline — O(1), no table scan.
        self._invalidate_cache("begin_migration")

    def finish_migration(self, flow: int, dst_pid: int) -> List[SubBatch]:
        """Re-home the flow and release its buffered packets to dst."""
        self.flow_table[flow] = dst_pid
        buffered = self.halted_flows.pop(flow, [])
        for s in buffered:
            s.pid = dst_pid
        # REQUIRED bump: the flow's cached home is now wrong; revalidation-
        # on-hit refreshes it (and everyone else) on next appearance.
        self._invalidate_cache("finish_migration")
        return buffered

    # -- adaptive scaling hooks (§6.1) -------------------------------------------
    def add_pipeline(self, capacity: float) -> int:
        # No epoch bump: existing homes stay valid, and hits never consult
        # the new pipeline (home-first semantics; see DESIGN.md).
        pid = len(self.pipelines)
        self.pipelines.append(PipelineStatus(pid=pid, capacity=capacity))
        return pid

    def halt_pipeline(self, pid: int) -> List[int]:
        """Deactivate a pipeline; returns the flows that must migrate."""
        self.pipelines[pid].active = False
        # Scale-down/failover bump. (The fast path's active[home] check
        # already rejects hits on a halted pipeline; the bump additionally
        # forces re-validation of everything placed under the old topology.)
        self._invalidate_cache("halt_pipeline")
        return [f for f, p in self.flow_table.items() if p == pid]

    def utilization(self) -> Dict[int, float]:
        return {p.pid: (p.load / p.capacity if p.capacity else 0.0)
                for p in self.pipelines}
