"""Executors + the fused parallel data plane (paper §3, §5).

An Executor is the isolated runtime for one stage (paper: a container; here:
one program, shared process-wide by every replica of the stage). A
PipelineRunner chains executors; the ParallelDataPlane couples a
TrafficOrchestrator with N pipeline replicas and per-pipeline ring buffers,
implementing partition -> process -> aggregate.

Steady-state per-batch cost is ONE vectorized host pass (the TO's per-flow
partition, numpy) plus ONE dispatch on the device that does everything
else:

  gather+pad packets into (N, M) lanes -> push/pop the persistent stacked
  ingress rings -> run the full stage chain once over all lanes -> gather
  the egress back to original packet order.

``M`` is the per-pipeline sub-batch slot count, padded up to a power-of-two
bucket, and the ingress batch and egress length are bucketed the same way,
so the set of dispatch shapes stays small and bounded. PyTorch runs
eagerly, so a "compile" is counted as the reference's fallback counts it:
one per new shape key of the shared dispatch program (``dispatch_stats``;
zero growth in steady state). Rings are allocated once per data plane (one
stacked device buffer for all N pipelines) and updated in place.

Semantics contract (tested): ParallelDataPlane(app, R).process(batch) ==
graph.run_pipeline(app, batch) up to packet order — i.e. replication and
traffic partitioning never change application semantics. With migration
active, packets of halted flows are buffered by the TO and the processed
remainder is returned in original relative order.

That contract presumes UCFs are **per-packet (elementwise)**: the dispatch
runs the chain over all lanes at once, including pad slots whose content is
stale ring data; pad outputs are never referenced by the egress gather, but
a non-elementwise UCF would observe them. All paper apps (apps/nf.py) are
elementwise per the Table 2 paradigm ops.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.core.graph import (MeiliApp, PacketBatch, _cache_stats,
                                    apply_stage, bits, cache_put, chain_key,
                                    chain_runner, stage_runner, take,
                                    tree_leaves, tree_map)
from repro_torch.core.orchestrator import SubBatch, TrafficOrchestrator
from repro_torch.core.ringbuffer import Ring, make_rings, pop_many, push_many
from repro_torch.core import replication as repl
from repro_torch.hw import resolve_device

MIN_BUCKET = 16


def _bucket(n: int) -> int:
    """Round a sub-batch size up to the next power-of-two slot count."""
    return max(MIN_BUCKET, 1 << (max(1, n) - 1).bit_length())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Executor:
    """One stage's runtime (one program, shared by all its replicas —
    replicas differ in placement/timing, not in program)."""

    def __init__(self, fn):
        self.fn = fn
        self.run = stage_runner(fn)          # process-wide cached program


class PipelineRunner:
    def __init__(self, app: MeiliApp):
        self.executors = [Executor(f) for f in app.stages]
        self._chain = chain_runner(app)      # one program per chain

    def process(self, batch: PacketBatch) -> PacketBatch:
        return self._chain(batch)


class _DispatchProgram:
    """The fused dispatch of one stage chain, shared by every data plane in
    the process. ``shape_keys`` plays the part of jax.jit's specialization
    cache: a key seen for the first time is one "compile"."""

    def __init__(self, stages):
        self.stages = tuple(stages)
        self.shape_keys: Set[Any] = set()

    def __call__(self, rings: Ring, batch: PacketBatch, perm: torch.Tensor,
                 counts: torch.Tensor, out_idx: torch.Tensor) -> PacketBatch:
        # perm: (N, M) source index per lane slot; counts: (N,) valid
        # slots per lane; out_idx: (B,) flat lane*M+slot per egress row.
        stacked = tree_map(lambda a: take(a, perm), batch)       # (N, M, ...)
        push_many(rings, stacked, counts)                        # ingress
        _, rows, _valid = pop_many(rings, perm.shape[1])
        flat = tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), rows)
        for fn in self.stages:
            flat = apply_stage(fn, flat)
        return tree_map(lambda a: take(a, out_idx), flat)        # egress


_DISPATCH_PROGRAMS: Dict[Any, Callable] = {}


def _dispatch_program(app: MeiliApp) -> _DispatchProgram:
    # The "dispatch" hit/miss counters are bumped per *call* in
    # ParallelDataPlane.process(), not here (one lookup per plane).
    key = chain_key(app)
    prog = _DISPATCH_PROGRAMS.get(key)
    if prog is None:
        prog = cache_put(_DISPATCH_PROGRAMS, key,
                         _DispatchProgram(app.stages),
                         stats=_cache_stats("dispatch"))
    return prog


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    pad = torch.zeros((n,) + a.shape[1:], dtype=a.dtype, device=a.device)
    return torch.cat([bits(a), bits(pad)], dim=0).view(a.dtype)


class ParallelDataPlane:
    """N replicated pipelines + TO + persistent per-pipeline ring buffers."""

    def __init__(self, app: MeiliApp, num_pipelines: Optional[int] = None,
                 R: Optional[Dict[str, int]] = None,
                 latencies: Optional[Dict[str, float]] = None,
                 capacity_per_pipeline: float = 256.0,
                 ring_capacity: int = 4096,
                 metrics=None, profile: bool = False,
                 flow_cache: bool = True, flow_cache_config=None,
                 table_cap: Optional[int] = None, trace=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if num_pipelines is None:
            if R is None:
                if latencies is None:
                    raise ValueError("need num_pipelines, R or latencies")
                R = repl.num_replication(app.stage_names(), latencies)
            num_pipelines = repl.num_pipelines(R)
        self.app = app
        self.R = R
        # Megaflow fast path: classification served from the device-resident
        # exact-match cache; the TO's slow loop runs only on misses.
        # `flow_cache=False` restores the pure slow path; semantics are
        # byte-identical either way.
        fc = None
        if flow_cache:
            from repro_torch.core.flowcache import FlowCache, FlowCacheConfig
            fc = FlowCache(flow_cache_config or FlowCacheConfig(),
                           device=self.device)
        self.to = TrafficOrchestrator(num_pipelines, capacity_per_pipeline,
                                      flow_cache=fc, table_cap=table_cap,
                                      trace=trace)
        self._cache_metric_base: Dict[str, int] = {}
        self.pipelines = [PipelineRunner(app) for _ in range(num_pipelines)]
        self.ring_capacity = ring_capacity
        self._dispatch = _dispatch_program(app)
        self._rings: Optional[Ring] = None
        self._ring_cap = 0
        self._ring_lanes = 0
        self._ring_proto_key = None
        # compiles = new shape keys of the shared dispatch program (one per
        # bucketed shape). by_tenant: per-tenant call/packet attribution
        # when the caller tags batches with the submitting tenant.
        self.dispatch_stats: Dict[str, Any] = {
            "calls": 0, "compiles": 0, "by_tenant": {}}
        # Observability hooks: an optional metrics registry (duck-typed:
        # counter/gauge/histogram) for call/compile counters, and a profile
        # flag that times every dispatch to completion (synchronize) into a
        # histogram — OFF by default because it serializes the device queue.
        self.metrics = metrics
        self.profile = profile

    def _tag_tenant(self, tenant: Optional[str], packets: int) -> None:
        if tenant is None:
            return
        per = self.dispatch_stats["by_tenant"].setdefault(
            tenant, {"calls": 0, "packets": 0})
        per["calls"] += 1
        per["packets"] += int(packets)

    def _check_device(self, batch: PacketBatch) -> None:
        if batch.device.type != self.device.type or (
                self.device.index is not None
                and batch.device.index != self.device.index):
            raise ValueError(f"batch on {batch.device}, data plane on "
                             f"{self.device}")

    def _empty_result(self, batch: PacketBatch) -> PacketBatch:
        """A zero-packet batch with the same tree structure a processed
        round returns (UCF-added meta keys included): the chain runs on a
        MIN_BUCKET dummy — not on zero rows, which some kernels reject —
        and the result is sliced empty."""
        dummy = tree_map(
            lambda a: torch.zeros((MIN_BUCKET,) + a.shape[1:], dtype=a.dtype,
                                  device=a.device), batch)
        return tree_map(lambda a: a[:0], chain_runner(self.app)(dummy))

    # -- persistent stacked rings ---------------------------------------------
    def _ensure_rings(self, batch: PacketBatch, M: int) -> None:
        proto = tree_map(lambda a: a[0], batch)
        proto_key = tuple((tuple(a.shape), str(a.dtype))
                          for a in tree_leaves(proto))
        lanes = len(self.to.pipelines)
        if (self._rings is None or M > self._ring_cap
                or lanes != self._ring_lanes
                or proto_key != self._ring_proto_key):
            # Power-of-two cap: cursors are monotonic int32 indexed & (cap-1),
            # exact across the int32 wrap only when cap divides 2^32.
            self._ring_cap = _bucket(max(self.ring_capacity, M))
            self._ring_lanes = lanes
            self._rings = make_rings(proto, self._ring_cap, lanes)
            self._ring_proto_key = proto_key

    def _sync_cache_metrics(self) -> None:
        """Publish flow-cache counter deltas into the metrics registry
        (counters only go up, so we ship increments from a local base)."""
        fc = self.to.flow_cache
        if fc is None or self.metrics is None:
            return
        snap = {"hits": fc.stats["hits"], "misses": fc.stats["misses"],
                "evictions": fc.stats["evictions"],
                "invalidations": fc.stats["invalidations"]}
        for k, v in snap.items():
            d = v - self._cache_metric_base.get(k, 0)
            if d > 0:
                self.metrics.counter(f"flow_cache_{k}_total",
                                     app=self.app.name).inc(d)
        self._cache_metric_base = snap

    def flow_cache_stats(self) -> Dict[str, Any]:
        """Fast-path counters for bench records: TO batch classification
        plus the cache's own stats (empty dict when the cache is off)."""
        fc = self.to.flow_cache
        if fc is None:
            return {}
        return dict(self.to.fast_stats, **fc.stats_snapshot())

    # -- partition -> fused dispatch -> aggregate ------------------------------
    def process(self, batch: PacketBatch,
                tenant: Optional[str] = None) -> PacketBatch:
        self._check_device(batch)
        assign = self.to.partition_assign(batch, tenant=tenant)
        proc = np.nonzero(assign >= 0)[0]      # halted-flow packets buffered
        self._tag_tenant(tenant, proc.size)
        if proc.size == 0:
            return self._empty_result(batch)
        lanes_of = assign[proc]
        N = len(self.to.pipelines)
        counts = np.bincount(lanes_of, minlength=N).astype(np.int32)
        M = _bucket(int(counts.max()))

        # Host-side index algebra (numpy, O(B)): lane slot per packet and the
        # egress gather index that undoes the lane layout. Lane ids take only
        # N values, so a counting sort (one flatnonzero pass per lane) beats
        # a comparison argsort and is equally stable.
        order = np.concatenate(
            [np.flatnonzero(lanes_of == i) for i in range(N)])
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lanes_sorted = lanes_of[order]
        ranks = np.arange(proc.size) - starts[lanes_sorted]
        perm = np.zeros((N, M), np.int64)      # pad slots gather row 0 (masked)
        perm[lanes_sorted, ranks] = proc[order]
        out_idx = np.empty(proc.size, np.int64)
        out_idx[order] = lanes_sorted * M + ranks

        # Every dispatch shape is bucketed — M above, and here the ingress
        # batch and egress index — so variable-size traffic (B drifting round
        # to round) adds at most one shape per pow-2 bucket, not per size.
        B = batch.batch
        B_pad = _bucket(B)
        if B_pad != B:
            batch = tree_map(lambda a: _pad_rows(a, B_pad - B), batch)
        P = proc.size
        P_pad = _bucket(P)
        if P_pad != P:
            out_idx = np.concatenate([out_idx, np.zeros(P_pad - P, np.int64)])

        self._ensure_rings(batch, M)
        self.dispatch_stats["calls"] += 1
        t0 = time.perf_counter() if self.profile else 0.0

        dev = self.device
        try:
            out = self._dispatch(
                self._rings, batch, torch.from_numpy(perm).to(dev),
                torch.from_numpy(counts).to(dev),
                torch.from_numpy(out_idx).to(dev))
        except BaseException:
            # The ring may be half-updated; drop it so the next round
            # reallocates instead of reading torn cursors.
            self._rings = None
            raise

        skey = (B_pad, P_pad, M, N, self._ring_cap, self._ring_proto_key)
        compiled = skey not in self._dispatch.shape_keys
        if compiled:
            self._dispatch.shape_keys.add(skey)
            self.dispatch_stats["compiles"] += 1
        # Process-wide cache counters: one dispatch call == one cache event;
        # miss == a shape key the shared program had not seen.
        dstats = _cache_stats("dispatch")
        dstats["miss" if compiled else "hit"] += 1
        if self.profile:
            _sync(dev)
            us = (time.perf_counter() - t0) * 1e6
            if self.metrics is not None:
                self.metrics.histogram("dataplane_dispatch_us",
                                       app=self.app.name).observe(us)
        if self.metrics is not None:
            self._sync_cache_metrics()
            self.metrics.counter("dataplane_dispatch_calls_total",
                                 app=self.app.name).inc()
            if self.dispatch_stats["compiles"] > 0:
                self.metrics.gauge("dataplane_dispatch_compiles",
                                   app=self.app.name).set(
                                       self.dispatch_stats["compiles"])
        if P_pad != P:
            out = tree_map(lambda a: a[:P], out)
        return out

    # -- per-stage device profiling ----------------------------------------------
    def profile_stages(self, batch: PacketBatch,
                       iters: int = 1) -> Dict[str, float]:
        """Time each stage's program to completion on ``batch`` and return
        mean µs per stage. Runs OUTSIDE the fused dispatch (stage programs
        are the same process-wide cached ones the unfused path uses), so a
        profile never perturbs the dispatch's shape-key counters. Timings
        land in the attached registry as ``dataplane_stage_us{app, stage}``
        histograms."""
        out: Dict[str, float] = {}
        cur = batch
        for fn in self.app.stages:
            run = stage_runner(fn)
            run(cur)                                   # warm: kernel build
            _sync(cur.device)
            t0 = time.perf_counter()
            for _ in range(max(1, iters)):
                nxt = run(cur)
                _sync(cur.device)
            us = (time.perf_counter() - t0) * 1e6 / max(1, iters)
            out[fn.name] = us
            if self.metrics is not None:
                self.metrics.histogram("dataplane_stage_us",
                                       app=self.app.name,
                                       stage=fn.name).observe(us)
            cur = nxt
        return out

    # -- unfused reference path (kept as the dispatch-layer oracle) ------------
    def process_unfused(self, batch: PacketBatch,
                        tenant: Optional[str] = None) -> PacketBatch:
        """Per-sub-batch dispatch through PipelineRunner, then sequence-number
        aggregation — the pre-fusion data path, retained for A/B tests."""
        self._check_device(batch)
        subs = self.to.partition(batch)
        self._tag_tenant(tenant, sum(s.indices.size for s in subs))
        if not subs:                       # empty batch or every flow halted
            return self._empty_result(batch)
        done: List[SubBatch] = []
        for sub in subs:
            out = self.pipelines[sub.pid].process(sub.data)
            done.append(SubBatch(pid=sub.pid, seq=sub.seq,
                                 indices=sub.indices, data=out))
        # With migration active the survivors are a subset of the batch:
        # remap original positions to ranks among survivors so aggregate
        # reorders within the processed subset.
        survivors = np.sort(np.concatenate([s.indices for s in done]))
        if survivors.size < batch.batch:
            done = [SubBatch(pid=s.pid, seq=s.seq,
                             indices=np.searchsorted(survivors, s.indices),
                             data=s.data) for s in done]
        return self.to.aggregate(done, total=survivors.size)
