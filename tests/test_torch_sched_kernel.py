"""The port's scheduling kernels (``repro_torch.core.sched_kernel``) held
against the scalar governor and against the JAX package's kernels.

* Every case of ``test_sched_kernel.py`` runs on the port's kernels
  (``VectorizedScheduler(device="cpu")``) against the port's scalar
  ``ResourceGovernor.dwrr_schedule`` (itself held to the reference's with
  ``==`` in ``test_torch_qos.py``), the property cases on the same
  ``_hypothesis_shim`` draws. Tolerance: the reference's contract
  (``_assert_equivalent``, ``tests/test_sched_kernel.py:25-50``): per
  tenant ``max(1e-2, 1.05 * quantum * weight + 5e-4 * served)``, and the
  order of substantively served tenants from a fresh ring. The port's own
  ``sched_kernel.contract_errors`` states the same contract (``chip_smoke.py``
  and the card tests use it) and must agree with the reference's check.
* The port's ``dwrr_step`` against the reference's ``dwrr_step`` on the same
  f32 inputs. Found: not bit-equal. PyTorch's CPU ``cumsum`` accumulates
  f32 in f64 and XLA's in f32, and the two sums of a round's takes run in
  other orders, so served bytes part by a few f32 ulps of the budget and,
  where the budget truncates a round, the round count by one. Held within
  the same contract (served bytes per tenant; round counts within one).
  The port departs from the reference's kernel in two places, both toward
  the scalar oracle (module doc of ``repro_torch.core.sched_kernel``): its
  ring turns over the live rows, not the padded ones, and a round the
  budget truncates leaves the budget at exactly 0. Over padded rows the
  reference's kernel leaves its own contract (pinned below at 200 tenants
  in 256 rows); the port stays within it at 200 and 1,024 tenants.
* The block size of the round loop (``ROUNDS_PER_CHECK``) changes nothing:
  outputs bit-equal at 1, 3, 16 and 64 rounds a block; a steady tick reads
  the device twice (one block, one readback of served bytes and stamps).
"""
import random
import time

import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

import jax.numpy as jnp
from repro.core import sched_kernel as jsk
from repro_torch.core import sched_kernel as sk
from repro_torch.core.qos import ResourceGovernor, TenantQuota
from test_sched_kernel import _assert_equivalent as ref_assert_equivalent

RTOL = sk.RTOL
ATOL = sk.ATOL


def _mk_gov(weights, **quota_kw):
    gov = ResourceGovernor()
    for t, w in weights.items():
        gov.register(t, TenantQuota(weight=w, **quota_kw))
    return gov


def _sched(**kw):
    return sk.VectorizedScheduler(device="cpu", **kw)


def _rand_case(rng, n):
    names = [f"t{i:02d}" for i in range(n)]
    weights = {t: rng.choice([0.5, 1.0, 1.0, 2.0, 3.0, 5.0]) for t in names}
    queues = {t: rng.uniform(0.0, 20000.0) for t in names}
    caps = {t: rng.choice([rng.uniform(100.0, 15000.0), float("inf")])
            for t in names}
    return names, weights, queues, caps


def _assert_equivalent(order_s, served_s, order_k, served_k, budget,
                       weights, check_order=True):
    errs = sk.contract_errors(order_s, served_s, order_k, served_k, budget,
                              weights, check_order)
    assert errs == []
    ref_assert_equivalent(order_s, served_s, order_k, served_k, budget,
                          weights, check_order)


# -- capped DWRR ---------------------------------------------------------------

def test_dwrr_capped_matches_scalar_seeded():
    rng = random.Random(42)
    for case in range(25):
        n = rng.randint(1, 24)
        names, weights, queues, caps = _rand_case(rng, n)
        budget = rng.uniform(100.0, 50000.0)

        scalar = _mk_gov(weights)
        o_s, s_s = scalar.dwrr_schedule(dict(queues), dict(caps),
                                        capacity_bytes=budget)
        kern = _mk_gov(weights)
        kern.attach_kernel(_sched())
        o_k, s_k = kern.dwrr_schedule(dict(queues), dict(caps),
                                      capacity_bytes=budget)
        _assert_equivalent(o_s, s_s, o_k, s_k, budget, weights)
        # Conservation: never serve more than budget or demand.
        assert sum(s_k.values()) <= budget * (1 + RTOL) + ATOL
        for t in names:
            assert s_k[t] <= queues[t] * (1 + RTOL) + ATOL
            assert s_k[t] <= caps[t] * (1 + RTOL) + ATOL


def test_dwrr_capped_multi_tick_static_membership():
    """Deficits and the ring offset persist across ticks: a multi-tick
    sequence with static membership stays equivalent, not just tick one."""
    rng = random.Random(7)
    names, weights, _, _ = _rand_case(rng, 9)
    scalar = _mk_gov(weights)
    kern = _mk_gov(weights)
    kern.attach_kernel(_sched())
    for tick in range(12):
        queues = {t: rng.uniform(0.0, 8000.0) for t in names}
        caps = {t: rng.uniform(500.0, 6000.0) for t in names}
        budget = rng.uniform(2000.0, 20000.0)
        o_s, s_s = scalar.dwrr_schedule(dict(queues), dict(caps),
                                        capacity_bytes=budget)
        o_k, s_k = kern.dwrr_schedule(dict(queues), dict(caps),
                                      capacity_bytes=budget)
        _assert_equivalent(o_s, s_s, o_k, s_k, budget, weights,
                           check_order=(tick == 0))


def test_dwrr_weights_shape_longrun_share():
    """Weights 2:1:1 converge to ~2:1:1 served bytes under saturation —
    the classic DRR property, on the kernel path."""
    weights = {"a": 2.0, "b": 1.0, "c": 1.0}
    gov = _mk_gov(weights)
    gov.attach_kernel(_sched())
    tot = {t: 0.0 for t in weights}
    for _ in range(50):
        _, served = gov.dwrr_schedule(
            {t: 1e6 for t in weights}, None, capacity_bytes=4000.0)
        for t, v in served.items():
            tot[t] += v
    assert tot["a"] / tot["b"] == pytest.approx(2.0, rel=0.05)
    assert tot["b"] / tot["c"] == pytest.approx(1.0, rel=0.05)


@settings(max_examples=30, deadline=None)
@given(st.integers(min_value=1, max_value=16),
       st.integers(min_value=0, max_value=2**31 - 1))
def test_dwrr_capped_matches_scalar_hypothesis(n, seed):
    rng = random.Random(seed)
    names, weights, queues, caps = _rand_case(rng, n)
    budget = rng.uniform(100.0, 50000.0)
    scalar = _mk_gov(weights)
    o_s, s_s = scalar.dwrr_schedule(dict(queues), dict(caps),
                                    capacity_bytes=budget)
    kern = _mk_gov(weights)
    kern.attach_kernel(_sched())
    o_k, s_k = kern.dwrr_schedule(dict(queues), dict(caps),
                                  capacity_bytes=budget)
    _assert_equivalent(o_s, s_s, o_k, s_k, budget, weights)


# -- uncapped (order-only) mode ------------------------------------------------

def test_dwrr_uncapped_matches_scalar_seeded():
    rng = random.Random(11)
    for _ in range(20):
        n = rng.randint(1, 20)
        names, weights, queues, caps = _rand_case(rng, n)
        scalar = _mk_gov(weights)
        o_s, s_s = scalar.dwrr_schedule(dict(queues), dict(caps),
                                        capacity_bytes=None)
        kern = _mk_gov(weights)
        kern.attach_kernel(_sched())
        o_k, s_k = kern.dwrr_schedule(dict(queues), dict(caps),
                                      capacity_bytes=None)
        # Order-only mode has no sequential budget: order is an exact sort,
        # so it must match the scalar exactly (ties break by name).
        assert o_s == o_k
        for t in names:
            assert s_k[t] == pytest.approx(s_s[t], rel=RTOL, abs=ATOL)


def test_dwrr_uncapped_tie_break_by_name():
    weights = {"z": 1.0, "a": 1.0, "m": 1.0}
    gov = _mk_gov(weights)
    gov.attach_kernel(_sched())
    order, served = gov.dwrr_schedule({t: 100.0 for t in weights},
                                      {t: 50.0 for t in weights},
                                      capacity_bytes=None)
    assert order == ["a", "m", "z"]
    assert served == {t: pytest.approx(50.0) for t in weights}


# -- scale_decisions vs scale_verdict ------------------------------------------

def _scale_case(rng, brownout):
    n = rng.randint(1, 12)
    names = [f"s{i:02d}" for i in range(n)]
    weights = {t: rng.choice([1.0, 2.0, 4.0]) for t in names}
    quota = {t: rng.choice([None, rng.uniform(5.0, 30.0)]) for t in names}
    burst = {t: rng.choice([0.0, rng.uniform(1.0, 8.0)]) for t in names}
    gov = ResourceGovernor()
    for t in names:
        gov.register(t, TenantQuota(weight=weights[t], max_gbps=quota[t],
                                    burst_gbps=burst[t]))
    if brownout:
        gov.set_brownout(rng.uniform(0.2, 0.8))
    gov.begin_tick(active=names)
    rows = {t: dict(est_gbps=rng.uniform(0.0, 40.0),
                    offered_gbps=rng.uniform(0.0, 40.0),
                    contract_gbps=rng.uniform(5.0, 25.0),
                    current_gbps=rng.uniform(0.0, 30.0),
                    achievable_gbps=rng.uniform(1.0, 30.0))
            for t in names}
    return gov, names, rows


def _f32(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _run_scale_both(gov, names, rows):
    # Kernel inputs snapshot BEFORE the scalar calls mutate credits.
    creds = np.array([gov.credits.get(t, 0.0) for t in names],
                     dtype=np.float32)
    quota = np.array([gov.quota(t).max_gbps
                      if gov.quota(t).max_gbps is not None else np.inf
                      for t in names], dtype=np.float32)
    w = np.array([gov.weight(t) for t in names], dtype=np.float32)
    wmax = max((q.weight for q in gov.quotas.values()), default=1.0)
    blevel = gov._brownout if gov._brownout is not None else 1.0
    cols = {k: np.array([rows[t][k] for t in names], dtype=np.float32)
            for k in ("est_gbps", "offered_gbps", "contract_gbps",
                      "current_gbps", "achievable_gbps")}
    granted, rescale, pressure, browned, _ = sk.scale_decisions(
        _f32(cols["est_gbps"]), _f32(cols["offered_gbps"]),
        _f32(cols["contract_gbps"]), _f32(cols["current_gbps"]),
        _f32(cols["achievable_gbps"]), _f32(quota), _f32(creds), _f32(w),
        _f32(blevel), _f32(wmax), _f32(1.15), _f32(0.2),
        _f32(gov.pressure_frac), _f32(0.1))
    verdicts = [gov.scale_verdict(t, **rows[t]) for t in names]
    return (granted.numpy(), rescale.numpy(), pressure.numpy(),
            browned.numpy(), verdicts)


@pytest.mark.parametrize("brownout", [False, True])
def test_scale_decisions_matches_scale_verdict(brownout):
    rng = random.Random(97 + brownout)
    for case in range(20):
        gov, names, rows = _scale_case(rng, brownout)
        granted, rescale, pressure, browned, verdicts = _run_scale_both(
            gov, names, rows)
        for i, (t, v) in enumerate(zip(names, verdicts)):
            assert float(granted[i]) == pytest.approx(
                v.target_gbps, rel=1e-4, abs=1e-4), (case, t)
            assert bool(rescale[i]) == v.rescale, (case, t)
            assert bool(pressure[i]) == v.pressure, (case, t)
            assert bool(browned[i]) == v.brownout, (case, t)


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.booleans())
def test_scale_decisions_matches_scale_verdict_hypothesis(seed, brownout):
    rng = random.Random(seed)
    gov, names, rows = _scale_case(rng, brownout)
    granted, rescale, pressure, browned, verdicts = _run_scale_both(
        gov, names, rows)
    for i, v in enumerate(verdicts):
        assert float(granted[i]) == pytest.approx(
            v.target_gbps, rel=1e-4, abs=1e-4)
        assert bool(rescale[i]) == v.rescale


# -- burst refill / queue drain ------------------------------------------------

def test_refill_credits_matches_begin_tick():
    rng = random.Random(3)
    names = [f"b{i}" for i in range(16)]
    depth = {t: rng.choice([0.0, rng.uniform(1.0, 10.0)]) for t in names}
    refill = {t: rng.uniform(0.1, 3.0) for t in names}
    gov = ResourceGovernor()
    for t in names:
        gov.register(t, TenantQuota(burst_gbps=depth[t],
                                    burst_refill_gbps=refill[t]))
        gov.credits[t] = rng.uniform(0.0, depth[t]) if depth[t] else 0.0
    before = np.array([gov.credits[t] for t in names], dtype=np.float32)
    out = sk.refill_credits(
        _f32(before), _f32([depth[t] for t in names]),
        _f32([refill[t] for t in names]))
    gov.begin_tick(active=names)
    for i, t in enumerate(names):
        assert float(out[i]) == pytest.approx(gov.credits[t],
                                              rel=1e-6, abs=1e-6)


def test_queue_drain_matches_measure_math():
    """queue_drain reproduces measure_tenant_tick's arrival/serve/carry
    arithmetic (lines it was lifted from) for random loads."""
    rng = random.Random(5)
    for _ in range(40):
        off = rng.uniform(0.0, 2e6)
        back = rng.uniform(0.0, 5e4)
        cap = rng.uniform(0.0, 2e6)
        grant = rng.choice([np.inf, rng.uniform(0.0, 1e5)])
        dt = 0.1
        arriving = off * dt + back
        served_ref = min(arriving, cap * dt, grant)
        served, new_back, ach = sk.queue_drain(
            _f32(off), _f32(back), _f32(cap), _f32(grant), _f32(dt))
        assert float(served) == pytest.approx(served_ref, rel=1e-5, abs=1e-2)
        assert float(new_back) == pytest.approx(arriving - served_ref,
                                                rel=1e-4, abs=0.5)
        assert float(ach) == pytest.approx(served_ref / dt, rel=1e-5,
                                           abs=1e-1)


# -- telemetry reduction -------------------------------------------------------

def test_telemetry_reduce_matches_dict_loop():
    rng = random.Random(13)
    tenants = ["a", "b", "c", "d"]
    recs = [(rng.choice(tenants), rng.uniform(0, 10), rng.uniform(0, 5))
            for _ in range(200)]
    idx = np.array([tenants.index(t) for t, _, _ in recs])
    off = np.array([o for _, o, _ in recs])
    p99 = np.array([p for _, _, p in recs])
    counts, means, maxes = sk.telemetry_reduce_np(
        idx, len(tenants), {"off": off}, {"p99": p99})
    for i, t in enumerate(tenants):
        mine = [(o, p) for tt, o, p in recs if tt == t]
        assert counts[i] == len(mine)
        assert means["off"][i] == pytest.approx(
            sum(o for o, _ in mine) / len(mine))
        assert maxes["p99"][i] == pytest.approx(max(p for _, p in mine))


def test_telemetry_reduce_handles_absent_tenant():
    counts, means, maxes = sk.telemetry_reduce_np(
        np.array([0, 0]), 2, {"x": np.array([1.0, 3.0])},
        {"y": np.array([2.0, 4.0])})
    assert counts[1] == 0 and means["x"][1] == 0.0
    assert maxes["y"][1] == -np.inf


# -- padding / recompile discipline --------------------------------------------

def test_pad_rows_pow2():
    assert sk.pad_rows(1) == 8
    assert sk.pad_rows(8) == 8
    assert sk.pad_rows(9) == 16
    assert sk.pad_rows(100) == 128


def test_churn_repads_without_retracing():
    """Tenant churn inside one pow-2 bucket must not add a dwrr_step shape
    key; crossing a bucket boundary adds exactly one."""
    # max_rounds is part of the key: an unusual value gives this test its
    # own keys, isolating it from shapes other tests (or the same process's
    # earlier ticks) already used.
    sched = _sched(max_rounds=997)

    def tick(names):
        w = {t: 1.0 for t in names}
        sched.schedule({t: 100.0 for t in names}, None, 1000.0, weights=w)

    names = [f"c{i:02d}" for i in range(5)]
    tick(names)
    sk.reset_trace_counts()
    tick(names[:4])          # churn within the 8-row bucket
    tick(names)              # and back
    assert sk.trace_counts().get("dwrr_step", 0) == 0
    tick([f"c{i:02d}" for i in range(9)])   # 8 -> 16 rows: one new key
    assert sk.trace_counts().get("dwrr_step", 0) == 1


def test_fast_smoke_200_tenants_tick_budget_and_zero_recompiles():
    """A 200-tenant tick on the vectorized path stays under a generous
    host-time budget with no new shape key in steady state."""
    n = 200
    weights = {f"m{i:03d}": float(1 + i % 4) for i in range(n)}
    gov = _mk_gov(weights)
    gov.attach_kernel(_sched())
    rng = random.Random(0)

    def one_tick():
        q = {t: rng.uniform(0.0, 1e5) for t in weights}
        caps = {t: 5e4 for t in weights}
        gov.dwrr_schedule(q, caps, capacity_bytes=2e6)

    one_tick()                      # warmup: the first key
    sk.reset_trace_counts()
    t0 = time.perf_counter()
    ticks = 30
    for _ in range(ticks):
        one_tick()
    per_tick = (time.perf_counter() - t0) / ticks
    assert sk.trace_counts() == {}, "steady-state new shape key"
    assert per_tick < 0.05, f"tick cost {per_tick*1e3:.1f} ms over budget"


# -- the port's kernel against the reference's kernel --------------------------

def _raw_case(rng, n):
    N = sk.pad_rows(n)
    q, w, d, m = (np.zeros(N, np.float32) for _ in range(4))
    c = np.full(N, np.inf, np.float32)
    for i in range(n):
        q[i] = rng.uniform(0.0, 20000.0)
        w[i] = rng.choice([0.5, 1.0, 2.0, 3.0, 5.0])
        d[i] = rng.uniform(0.0, 500.0) if rng.random() < 0.5 else 0.0
        c[i] = rng.choice([rng.uniform(100.0, 15000.0), np.inf])
        m[i] = 1.0
    return q, w, d, c, m, np.float32(rng.uniform(100.0, 50000.0)), \
        rng.randrange(N)


def _port_step(q, w, d, c, m, b, off, max_rounds=1024):
    s, dn, st_, r = sk.dwrr_step(*(torch.from_numpy(a) for a in (q, w, d, c,
                                                                  m)),
                                 torch.tensor(b), off, max_rounds=max_rounds)
    return s.numpy(), dn.numpy(), st_.numpy(), r


@pytest.mark.parametrize("seed", range(4))
def test_dwrr_step_within_contract_of_reference_kernel(seed):
    """Same f32 inputs (deficits carried in, a rotated ring) into both
    packages' ``dwrr_step``: every row's served bytes within the contract's
    per-tenant tolerance, totals within RTOL of the budget, round counts
    within one. The reference's kernel takes the live rows alone: over
    padded rows its ring turns otherwise than the scalar's (module doc of
    ``repro_torch.core.sched_kernel``), over the live rows as the port's
    does. Bit-equality is not claimed (module doc of this file)."""
    rng = random.Random(1000 + seed)
    for _ in range(25):
        n = rng.choice([3, 8, 13, 16, 29, 40])
        q, w, d, c, m, b, _ = _raw_case(rng, n)
        off = rng.randrange(n)
        js, jd, jst, jr = jsk.dwrr_step(
            *(jnp.asarray(a[:n]) for a in (q, w, d, c, m)), jnp.float32(b),
            jnp.int32(off), max_rounds=1024)
        ps, pd, pst, pr = _port_step(q, w, d, c, m, b, off)
        js = np.asarray(js)
        assert abs(pr - int(jr)) <= 1
        quantum = float(b) / (8.0 * float(w.sum()))
        tol = np.maximum(ATOL, 1.05 * quantum * w[:n] + RTOL * js)
        assert (np.abs(ps[:n] - js) <= tol).all()
        assert abs(float(ps.sum()) - float(js.sum())) <= RTOL * float(b)
        assert (ps[n:] == 0).all() and (pd[n:] == 0).all()
        assert ((pst >= 0) == (ps > sk._EPS)).all()


@pytest.mark.parametrize("n", [200, 1024])
def test_every_tick_within_contract_at_scale(n):
    """The reference's 200-tenant smoke (weights 1 + i % 4, queues uniform in
    0-1e5 from ``random.Random(0)``, caps 5e4, 2e6 bytes a tick) and the same
    at 1,024 tenants: 31 ticks with persistent deficits and ring, each within
    the contract against the scalar governor fed the same inputs (order from
    the fresh ring). At 200 tenants the reference's kernel, whose ring turns
    over its 256 padded rows, leaves the contract once its ring offset
    passes 200 (tick 25 on)."""
    weights = {f"m{i:04d}": float(1 + i % 4) for i in range(n)}
    budget = 2e6
    scalar, port, ref = _mk_gov(weights), _mk_gov(weights), None
    port.attach_kernel(_sched())
    if n == 200:
        from repro.core.qos import ResourceGovernor as RefGovernor
        from repro.core.qos import TenantQuota as RefQuota
        ref = RefGovernor()
        for t, w in weights.items():
            ref.register(t, RefQuota(weight=w))
        ref.attach_kernel(jsk.VectorizedScheduler())
    rng = random.Random(0)
    ref_broke = []
    for tick in range(31):
        q = {t: rng.uniform(0.0, 1e5) for t in weights}
        caps = {t: 5e4 for t in weights}
        o_s, s_s = scalar.dwrr_schedule(dict(q), caps, capacity_bytes=budget)
        o_k, s_k = port.dwrr_schedule(dict(q), caps, capacity_bytes=budget)
        _assert_equivalent(o_s, s_s, o_k, s_k, budget, weights,
                           check_order=(tick == 0))
        if ref is not None:
            o_r, s_r = ref.dwrr_schedule(dict(q), caps, capacity_bytes=budget)
            if sk.contract_errors(o_s, s_s, o_r, s_r, budget, weights,
                                  check_order=(tick == 0)):
                ref_broke.append(tick)
    if ref is not None:
        assert ref_broke and min(ref_broke) >= 25


@pytest.mark.parametrize("block", [1, 3, 64])
def test_round_blocks_do_not_change_the_result(block, monkeypatch):
    rng = random.Random(5)
    for _ in range(10):
        args = _raw_case(rng, rng.randint(1, 30))
        want = _port_step(*args)
        monkeypatch.setattr(sk, "ROUNDS_PER_CHECK", block)
        got = _port_step(*args)
        monkeypatch.setattr(sk, "ROUNDS_PER_CHECK", 16)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert np.array_equal(a, b)
    # the loop's cap holds whatever the block size
    q, w, d, c, m, b, off = _raw_case(rng, 12)
    monkeypatch.setattr(sk, "ROUNDS_PER_CHECK", block)
    assert _port_step(q, w, d, c, m, b, off, max_rounds=2)[3] <= 2


def test_steady_tick_reads_the_device_twice():
    """One block of rounds (its condition and round count in one read) and
    one read of served bytes and stamps: two device-to-host reads a tick
    when the tick ends within ROUNDS_PER_CHECK rounds; membership changes
    (``sync``) read the deficits once more."""
    weights = {f"h{i:02d}": float(1 + i % 3) for i in range(20)}
    sched = _sched()
    rng = random.Random(2)
    q = {t: rng.uniform(0.0, 1e5) for t in weights}
    sched.schedule(q, None, 2e5, weights=weights)
    sk.reset_host_reads()
    sched.schedule(q, None, 2e5, weights=weights)
    assert sk.host_reads() == {"dwrr_step": 2}
    sk.reset_host_reads()
    sched.schedule(q, None, 2e5, weights={**weights, "new": 1.0})
    assert sk.host_reads() == {"sync": 1, "dwrr_step": 2}


def test_faulted_weight_breaks_the_contract():
    """The gate sees a wrong weight: one tenant's weight doubled in the
    kernel's copy only, on a tenant whose queue and cap exceed twice its
    fair share, must fail ``contract_errors``; the sound tick passes."""
    n = 200
    weights = {f"m{i:03d}": float(1 + i % 4) for i in range(n)}
    rng = random.Random(0)
    q = {t: rng.uniform(0.0, 1e5) for t in weights}
    caps = {t: 5e4 for t in weights}
    o_s, s_s = _mk_gov(weights).dwrr_schedule(dict(q), caps,
                                              capacity_bytes=2e6)
    o_k, s_k = _sched().schedule(dict(q), caps, 2e6, weights=weights)
    assert sk.contract_errors(o_s, s_s, o_k, s_k, 2e6, weights) == []
    victim = max((t for t in weights
                  if min(q[t], caps[t]) > 2 * s_s[t]),
                 key=lambda t: (s_s[t], t))
    bad = dict(weights, **{victim: 2 * weights[victim]})
    o_f, s_f = _sched().schedule(dict(q), caps, 2e6, weights=bad)
    errs = sk.contract_errors(o_s, s_s, o_f, s_f, 2e6, weights)
    assert any(e.startswith(f"{victim}:") for e in errs)


def test_scheduler_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sk.VectorizedScheduler()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sk.telemetry_state(4)


def test_telemetry_accumulate_equals_reference():
    rng = np.random.default_rng(3)
    n = 16
    state_j = jsk.telemetry_state(n)
    state_p = sk.telemetry_state(n, device="cpu")
    for _ in range(5):
        cols = [rng.uniform(0, 10, n).astype(np.float32) for _ in range(4)]
        mask = (rng.random(n) < 0.7).astype(np.float32)
        state_j = jsk.telemetry_accumulate(
            state_j, *(jnp.asarray(a) for a in cols), jnp.asarray(mask))
        state_p = sk.telemetry_accumulate(
            state_p, *(torch.from_numpy(a) for a in cols),
            torch.from_numpy(mask))
    for a, b in zip(state_j, state_p):
        assert np.array_equal(np.asarray(a), b.numpy())
