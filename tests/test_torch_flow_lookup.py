"""Port flow-lookup kernel and flow cache held against the JAX package.

The plain PyTorch probe is pinned to the reference's numpy oracle, its
jitted jnp version and its Pallas kernel in interpret mode, under forced
bucket collisions, full windows and epoch bumps; the port's FlowCache and
TrafficOrchestrator are driven through the same record/lookup/delete/expire
and migration/halt scripts as the reference's. Every compared output is an
integer, bool or plane array, so the tolerance is 0: bit for bit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.packets import pareto_flow_weights as jpareto
from repro.apps.packets import synth_packets_weighted as jsynth_weighted
from repro.core.flowcache import FlowCache as JFlowCache
from repro.core.flowcache import FlowCacheConfig as JFlowCacheConfig
from repro.core.orchestrator import TrafficOrchestrator as JTO
from repro.kernels import flow_lookup as jfl
from repro_torch import convert
from repro_torch.apps.packets import synth_packets_weighted
from repro_torch.core.flowcache import FlowCache, FlowCacheConfig
from repro_torch.core.orchestrator import TrafficOrchestrator
from repro_torch.kernels import flow_lookup as fl


def _fill(rng, n, cap, window, npipe=8):
    """Host planes holding n keys inserted window-style (first empty slot;
    overflowing keys dropped), epochs mixed over {0, 1, 2}."""
    key_lo = np.zeros(cap, np.uint32)
    key_hi = np.zeros(cap, np.uint32)
    pid = np.full(cap, -1, np.int32)
    ep = np.zeros(cap, np.int32)
    fids = rng.choice(np.int64(1) << 40, size=n, replace=False).astype(np.int64)
    fids[n // 2:] = -fids[n // 2:]          # negative fids round-trip too
    lo, hi = jfl.split_fids(fids)
    base = jfl.bucket_hash(lo, hi) & np.uint32(cap - 1)
    for i in range(n):
        for w in range(window):
            s = (int(base[i]) + w) & (cap - 1)
            if pid[s] < 0:
                key_lo[s], key_hi[s] = lo[i], hi[i]
                pid[s] = int(rng.integers(0, npipe))
                ep[s] = int(rng.integers(0, 3))
                break
    return (key_lo, key_hi, pid, ep), fids


def _queries(rng, fids, extra=40):
    absent = rng.choice(np.int64(1) << 40, size=extra).astype(np.int64) | (
        np.int64(1) << 41)
    q = np.concatenate([rng.choice(fids, size=min(len(fids), 88)), absent])
    rng.shuffle(q)
    F = 1 << (len(q) - 1).bit_length()
    return np.concatenate([q, np.zeros(F - len(q), np.int64)])


# cap, keys, window: light load, forced collisions (keys > cap), one window
# spanning the whole table, and a window of one slot.
CASES = [(1024, 256, 8), (64, 96, 8), (16, 40, 16), (128, 200, 1)]


@pytest.mark.parametrize("cap,n,window", CASES)
@pytest.mark.parametrize("cur_epoch", [0, 2])
def test_plain_lookup_equals_numpy_jnp_and_pallas(cap, n, window, cur_epoch):
    rng = np.random.default_rng(cap + n + window + cur_epoch)
    planes, fids = _fill(rng, n, cap, window)
    q = _queries(rng, fids)
    lo, hi = fl.split_fids(q)
    jlo, jhi = jfl.split_fids(q)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)

    s_np, p_np, f_np = jfl.lookup_numpy(*planes, lo, hi, cur_epoch, window)
    jp = [jnp.asarray(a) for a in planes]
    s_j, p_j, f_j = jfl.lookup_jnp(*jp, jnp.asarray(lo), jnp.asarray(hi),
                                   cur_epoch, window)
    s_p, p_p, f_p = jfl.lookup_pallas(*jp, jnp.asarray(lo), jnp.asarray(hi),
                                      cur_epoch, window, block_f=32,
                                      interpret=True)
    tp = [torch.from_numpy(a.copy()) for a in planes]
    s, p, f = fl.lookup(*tp, torch.from_numpy(lo), torch.from_numpy(hi),
                        cur_epoch, window)
    assert (s.dtype, p.dtype, f.dtype) == (torch.int32, torch.int32,
                                           torch.bool)
    for ours, *theirs in ((s, s_np, s_j, s_p), (p, p_np, p_j, p_p),
                          (f, f_np, f_j, f_p)):
        for t in theirs:
            np.testing.assert_array_equal(ours.numpy(),
                                          np.asarray(t).astype(ours.numpy().dtype))
    # the port's own numpy oracle is the reference's
    for a, b in zip(fl.lookup_numpy(*planes, lo, hi, cur_epoch, window),
                    (s_np, p_np, f_np)):
        np.testing.assert_array_equal(a, b)
    assert bool(f.any()) == bool(f_np.any())
    assert (s >= 0).sum() > 0


@pytest.mark.parametrize("cap,n,window", CASES)
def test_packed_lookup_equals_pallas(cap, n, window):
    """``lookup_packed``'s (3, F) int32 rows are the reference's slot, pid
    and fresh (as 0/1), and ``lookup`` returns the same three."""
    rng = np.random.default_rng(7 * cap + window)
    planes, fids = _fill(rng, n, cap, window)
    q = _queries(rng, fids)
    lo, hi = fl.split_fids(q)
    jp = [jnp.asarray(a) for a in planes]
    want = jfl.lookup_pallas(*jp, jnp.asarray(lo), jnp.asarray(hi), 1,
                             window, block_f=32, interpret=True)
    tp = [torch.from_numpy(a.copy()) for a in planes]
    args = (torch.from_numpy(lo), torch.from_numpy(hi), 1, window)
    packed = fl.lookup_packed(*tp, *args)
    assert packed.dtype == torch.int32 and packed.shape == (3, q.size)
    for row, w in zip(packed, want):
        np.testing.assert_array_equal(row.numpy(),
                                      np.asarray(w).astype(np.int32))
    assert torch.equal(fl.pack(*fl.lookup(*tp, *args)), packed)


def test_bucket_hash_wraps_like_uint32():
    rng = np.random.default_rng(1)
    lo = np.concatenate([rng.integers(0, 2 ** 32, 500, dtype=np.uint64)
                         .astype(np.uint32),
                         np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                                  np.uint32)])
    hi = lo[::-1].copy()
    want = jfl.bucket_hash(lo, hi)
    got = fl.bucket_hash_torch(torch.from_numpy(lo.astype(np.int64)),
                               torch.from_numpy(hi.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(fl.bucket_hash(lo, hi), want)


def test_apply_updates_drops_sentinels():
    rng = np.random.default_rng(2)
    cap = 64
    planes, _ = _fill(rng, 40, cap, 8)
    slots = np.array([3, cap, 17, cap + 9, 63, cap], np.int64)
    u_lo = rng.integers(0, 2 ** 32, 6, dtype=np.uint64).astype(np.uint32)
    u_hi = u_lo[::-1].copy()
    u_pid = np.arange(6, dtype=np.int32)
    u_ep = np.full(6, 5, np.int32)
    want = jfl.apply_updates([jnp.asarray(a) for a in planes], slots, u_lo,
                             u_hi, u_pid, u_ep)
    got = fl.apply_updates([torch.from_numpy(a.copy()) for a in planes],
                           slots, u_lo, u_hi, u_pid, u_ep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the flow cache and the orchestrator, driven by one script ----------------------

def _assert_cache_equal(a: FlowCache, b, ctx):
    # both mirrors flush their pending scatters here, so the stats agree
    assert a.check_device_mirror() and b.check_device_mirror(), ctx
    sa, sb = convert.flow_cache_state(a), convert.flow_cache_state(b)
    for k in ("key_lo", "key_hi", "pid", "ep", "stamp", "ref"):
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=f"{ctx} {k}")
    assert sa["epoch"] == sb["epoch"], ctx
    assert sa["stats"] == sb["stats"], ctx


@pytest.mark.parametrize("capacity,idle_ttl", [(64, 6), (256, 1000)])
def test_flow_cache_script_equals_reference(capacity, idle_ttl):
    kw = dict(capacity=capacity, idle_ttl=idle_ttl, expire_every=4)
    ours = FlowCache(FlowCacheConfig(**kw), device="cpu")
    ref = JFlowCache(JFlowCacheConfig(backend="jnp", **kw))
    rng = np.random.default_rng(capacity)
    universe = rng.choice(np.int64(1) << 36, size=3 * capacity,
                          replace=False).astype(np.int64)
    for rnd in range(1, 25):
        fids = rng.choice(universe, size=capacity // 2, replace=False)
        pids = rng.integers(0, 4, size=fids.size).astype(np.int32)
        for c in (ours, ref):
            c.record(fids, pids, rnd)
        q = np.concatenate([fids[:20], rng.choice(universe, 12)])
        for x, y in zip(ours.lookup(q), ref.lookup(q)):
            np.testing.assert_array_equal(x, y)
        if rnd % 5 == 0:
            for c in (ours, ref):
                c.invalidate("test")
        if rnd % 7 == 0:
            gone = fids[:8]
            assert ours.delete(gone) == ref.delete(gone)
        if rnd % 4 == 0:
            assert ours.expire_idle(rnd) == ref.expire_idle(rnd)
        _assert_cache_equal(ours, ref, f"round {rnd}")
        np.testing.assert_array_equal(ours.last_seen(q), ref.last_seen(q))
    assert ours.stats["evictions"] > 0 or capacity > 64
    # state carried across: a fresh port cache loaded from the reference's
    # planes answers every query the same way
    loaded = convert.load_flow_cache(
        FlowCache(FlowCacheConfig(**kw), device="cpu"),
        convert.flow_cache_state(ref))
    for x, y in zip(loaded.lookup(universe), ref.lookup(universe)):
        np.testing.assert_array_equal(x, y)


def _batch(t, drift, weighted):
    kw = dict(batch=96, num_flows=300, weights=jpareto(300, 1.2, seed=7),
              seed=(7, 0, t), pkt_bytes=64, flow_base=drift)
    return synth_packets_weighted(device="cpu", **kw), weighted(**kw)


SCRIPT = {3: ("migrate",), 5: ("migrate",), 6: ("finish",), 9: ("halt",),
          11: ("finish", "add"), 14: ("halt", "migrate")}


@pytest.mark.parametrize("cap", [40, 24, 12])
def test_orchestrator_with_cache_equals_reference(cap):
    """Roomy, tight and saturated pipelines (12 < 96 / 4 forces spills and
    fast-path fallbacks) under churn, migration, halt and scale-out."""
    npipe = 4
    mk = dict(capacity=1 << 10, idle_ttl=8, expire_every=4)
    a = TrafficOrchestrator(npipe, cap, flow_cache=FlowCache(
        FlowCacheConfig(**mk), device="cpu"), table_cap=200)
    b = JTO(npipe, cap, flow_cache=JFlowCache(JFlowCacheConfig(
        backend="jnp", **mk)), table_cap=200)
    mig = []
    for t in range(18):
        for op in SCRIPT.get(t, ()):
            if op == "migrate" and a.flow_table:
                f = sorted(a.flow_table)[len(a.flow_table) // 2]
                a.begin_migration(f), b.begin_migration(f)
                mig.append(f)
            elif op == "finish" and mig:
                f = mig.pop()
                a.finish_migration(f, t % npipe), b.finish_migration(f, t % npipe)
            elif op == "halt":
                live = [p.pid for p in a.pipelines if p.active]
                a.halt_pipeline(live[-1]), b.halt_pipeline(live[-1])
            elif op == "add":
                a.add_pipeline(cap), b.add_pipeline(cap)
        tb, jb = _batch(t, 11 * t, jsynth_weighted)
        np.testing.assert_array_equal(a.partition_assign(tb),
                                      b.partition_assign(jb), err_msg=f"t={t}")
        assert a.flow_table == b.flow_table
        assert a.spill_table == b.spill_table
        assert [p.load for p in a.pipelines] == [p.load for p in b.pipelines]
        assert sorted(a.halted_flows) == sorted(b.halted_flows)
        assert a.fast_stats == b.fast_stats
        _assert_cache_equal(a.flow_cache, b.flow_cache, f"t={t}")
    assert a.fast_stats["fast_batches"] > 0
