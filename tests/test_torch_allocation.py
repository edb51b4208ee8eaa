"""The port's pool and Algorithm 2/3 (``repro_torch.core.pool``,
``repro_torch.core.allocation``) held against the JAX package's.

* Every case of ``test_allocation.py`` runs on both packages (``PKGS``),
  the property cases on the same ``_hypothesis_shim`` draws, and each
  draw's allocation must be equal in the two packages.
* A seeded differential test over 200 random heterogeneous pools (racks,
  accelerators, bandwidths, failed and gray members) and stage chains runs
  ``resource_alloc`` -> ``commit`` -> ``check_ledger`` -> ``release`` in
  both packages. ``A``, ``unmet``, ``bw_after``, ``bw_charge``, the pool's
  ``snapshot()`` after each step, ``merge``, ``nic_charge``, the ledger's
  problem strings and every error message must be equal with ``==``: the
  port keeps the reference's iteration order and float operations, so
  nothing is compared within a tolerance.
"""
import types

import numpy as np
import pytest
from _hypothesis_shim import given, settings, st

from repro.core import allocation as jalloc
from repro.core import pool as jpool
from repro_torch.core import allocation, pool

PORT = types.SimpleNamespace(name="port", pool=pool, alloc=allocation)
REF = types.SimpleNamespace(name="ref", pool=jpool, alloc=jalloc)
PKGS = (PORT, REF)
IDS = [p.name for p in PKGS]


def _fields(a):
    return (a.A, a.unmet, a.bw_after, a.bw_charge)


def simple_pool(pkg, n=3, cores=8, bw=100.0):
    return pkg.pool.Pool([pkg.pool.NicSpec(f"n{i}", "x", cores, {}, bw)
                          for i in range(n)])


# -- test_allocation.py's cases on both packages -------------------------------

@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_locality_consolidates_consecutive_stages(pkg):
    p = simple_pool(pkg, n=3, cores=8)
    S = ["s1", "s2"]
    alloc = pkg.alloc.resource_alloc(S, {"s1": 2, "s2": 2},
                                     {"s1": 5.0, "s2": 5.0}, p,
                                     {s: pkg.pool.CPU for s in S})
    assert alloc.satisfied()
    assert alloc.num_nics_used() == 1
    assert alloc.nics_for("s1") == alloc.nics_for("s2")


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_spill_when_nic_full(pkg):
    p = simple_pool(pkg, n=2, cores=4)
    S = ["s1", "s2"]
    alloc = pkg.alloc.resource_alloc(S, {"s1": 4, "s2": 3},
                                     {"s1": 1.0, "s2": 1.0}, p,
                                     {s: pkg.pool.CPU for s in S})
    assert alloc.satisfied()
    assert alloc.num_nics_used() == 2


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_heterogeneous_isg_needs_pooling(pkg):
    p = pkg.pool.paper_cluster(n_bf2=1, n_bf1=0, n_pensando=1)
    S = ["cpu1", "regex", "aes"]
    need = {"cpu1": pkg.pool.CPU, "regex": pkg.pool.REGEX,
            "aes": pkg.pool.CRYPTO}
    alloc = pkg.alloc.resource_alloc(S, {s: 1 for s in S},
                                     {s: 5.0 for s in S}, p, need)
    assert alloc.satisfied()
    assert alloc.nics_for("regex") == ["bf2-0"]
    assert alloc.nics_for("aes") == ["pensando-0"]


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_bandwidth_cap_limits_allocation(pkg):
    p = pkg.pool.Pool([pkg.pool.NicSpec("small", "x", 8, {},
                                        bandwidth_gbps=10.0)])
    alloc = pkg.alloc.resource_alloc(["s1"], {"s1": 8}, {"s1": 5.0}, p,
                                     {"s1": pkg.pool.CPU})
    assert alloc.units("s1") == 2
    assert alloc.unmet["s1"] == 6


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_colocated_stage_shares_bandwidth(pkg):
    p = pkg.pool.Pool([pkg.pool.NicSpec("n0", "x", 8, {},
                                        bandwidth_gbps=10.0)])
    S = ["s1", "s2"]
    alloc = pkg.alloc.resource_alloc(S, {"s1": 2, "s2": 2},
                                     {"s1": 5.0, "s2": 5.0}, p,
                                     {s: pkg.pool.CPU for s in S})
    assert alloc.units("s1") == 2
    assert alloc.units("s2") == 2


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_best_effort_on_exhaustion(pkg):
    p = simple_pool(pkg, n=1, cores=2)
    alloc = pkg.alloc.resource_alloc(["s1"], {"s1": 5}, {"s1": 1.0}, p,
                                     {"s1": pkg.pool.CPU})
    assert not alloc.satisfied()
    assert alloc.units("s1") == 2
    assert alloc.unmet["s1"] == 3


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_commit_and_release_roundtrip(pkg):
    p = simple_pool(pkg, n=2, cores=4)
    S = ["s1"]
    need = {"s1": pkg.pool.CPU}
    t_s = {"s1": 2.0}
    before_free = p.free_total(pkg.pool.CPU)
    before_bw = p["n0"].free_bw_gbps
    alloc = pkg.alloc.resource_alloc(S, {"s1": 3}, t_s, p, need)
    pkg.alloc.commit(p, alloc, need)
    assert p.free_total(pkg.pool.CPU) == before_free - 3
    pkg.alloc.release(p, alloc, need, t_s)
    assert p.free_total(pkg.pool.CPU) == before_free
    assert p["n0"].free_bw_gbps == pytest.approx(before_bw)


def _never_overallocates(pkg, n_nics, cores, demand, thr, bw):
    p = pkg.pool.Pool([pkg.pool.NicSpec(f"n{i}", "x", cores, {}, bw)
                       for i in range(n_nics)])
    alloc = pkg.alloc.resource_alloc(["s"], {"s": demand}, {"s": thr}, p,
                                     {"s": pkg.pool.CPU})
    placed = alloc.units("s")
    assert placed + alloc.unmet.get("s", 0) == demand
    for n, row in alloc.A.items():
        assert row.get("s", 0) <= cores
        assert row.get("s", 0) * thr <= bw + thr
    assert all(v >= -1e-9 for v in alloc.bw_after.values())
    return _fields(alloc)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
@given(
    n_nics=st.integers(1, 6), cores=st.integers(1, 16),
    demand=st.integers(0, 64),
    thr=st.floats(0.5, 20.0), bw=st.floats(10.0, 200.0))
@settings(max_examples=150, deadline=None)
def test_property_never_overallocates(pkg, n_nics, cores, demand, thr, bw):
    got = _never_overallocates(pkg, n_nics, cores, demand, thr, bw)
    assert got == _never_overallocates(REF, n_nics, cores, demand, thr, bw)


def _two_stage_locality(pkg, n_nics, units):
    p = pkg.pool.Pool([pkg.pool.NicSpec(f"n{i}", "x", 2 * units, {}, 1000.0)
                       for i in range(n_nics)])
    S = ["a", "b"]
    alloc = pkg.alloc.resource_alloc(S, {"a": units, "b": units},
                                     {"a": 1.0, "b": 1.0}, p,
                                     {s: pkg.pool.CPU for s in S})
    assert alloc.satisfied()
    assert alloc.num_nics_used() == 1
    return _fields(alloc)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
@given(st.integers(1, 5), st.integers(1, 4))
@settings(max_examples=50, deadline=None)
def test_property_two_stage_locality(pkg, n_nics, units):
    got = _two_stage_locality(pkg, n_nics, units)
    assert got == _two_stage_locality(REF, n_nics, units)


# -- seeded differential: random heterogeneous pools and chains ----------------

KINDS = ("cpu", "regex", "crypto", "compression", "attention", "ssd")
NIC_KINDS = ("bf2", "bf1", "pensando", "group")


def _draw_case(rng):
    """One random pool and stage chain, as plain Python values that both
    packages build their objects from."""
    nics = []
    for i in range(int(rng.integers(1, 9))):
        accel = {k: int(rng.integers(0, 4)) for k in KINDS[1:]
                 if rng.random() < 0.5}
        bw = float(rng.choice([10.0, 25.0, 100.0, 400.0,
                               float(rng.uniform(1.0, 200.0))]))
        nics.append(dict(name=f"nic{i}", kind=str(rng.choice(NIC_KINDS)),
                         cores=int(rng.integers(0, 17)), accelerators=accel,
                         bandwidth_gbps=bw, rack=f"rack{rng.integers(0, 3)}"))
    failed = [n["name"] for n in nics if rng.random() < 0.15]
    gray = {n["name"]: float(rng.uniform(0.1, 1.0)) for n in nics
            if rng.random() < 0.2}
    n_stages = int(rng.integers(1, 6))
    S = [f"s{j}" for j in range(n_stages)]
    need = {s: str(rng.choice(KINDS, p=[0.5] + [0.1] * 5)) for s in S}
    r_s = {s: int(rng.integers(0, 13)) for s in S}
    t_s = {s: float(rng.choice([1.0, 5.0, float(rng.uniform(0.3, 60.0))]))
           for s in S}
    only = None
    if rng.random() < 0.25:
        only = [n["name"] for n in nics if rng.random() < 0.6]
    return nics, failed, gray, S, need, r_s, t_s, only


def _error(fn):
    """The exception's type and message, or None if ``fn`` returns."""
    try:
        fn()
    except (ValueError, AssertionError) as e:
        return type(e).__name__, str(e)
    return None


def _holdings(alloc, need):
    out = {}
    for n, row in alloc.A.items():
        for s, u in row.items():
            if u > 0:
                kinds = out.setdefault(n, {})
                kinds[need[s]] = kinds.get(need[s], 0) + u
    return out


def _run_case(pkg, case):
    """The whole script on one package; returns every observable in order."""
    nics, failed, gray, S, need, r_s, t_s, only = case
    p = pkg.pool.Pool([pkg.pool.NicSpec(**spec) for spec in nics])
    for n in failed:
        p.mark_failed(n)
    for n, f in gray.items():
        p.mark_gray(n, f)
    obs = [p.snapshot(), p.capacity_frac(p.names()),
           [p.rack_members(f"rack{r}") for r in range(3)]]
    a1 = pkg.alloc.resource_alloc(S, r_s, t_s, p, need, only_nics=only)
    obs += [_fields(a1), a1.satisfied(), a1.num_nics_used(),
            {s: (a1.nics_for(s), a1.units(s)) for s in S},
            {n: pkg.alloc.nic_charge(row, S, t_s) for n, row in a1.A.items()}]
    pkg.alloc.commit(p, a1, need)
    obs.append(p.snapshot())
    obs.append(p.check_ledger([_holdings(a1, need)], [a1.bw_charge],
                              strict=False))
    # a ledger that forgets the allocation: the problem strings and the
    # strict error are part of the contract
    obs.append(p.check_ledger(strict=False))
    obs.append(_error(lambda: p.check_ledger()))
    # a second tenant over what is left, then folded into the first
    a2 = pkg.alloc.resource_alloc(S, r_s, t_s, p, need)
    obs.append(_fields(a2))
    pkg.alloc.commit(p, a2, need)
    obs.append(p.snapshot())
    merged = pkg.alloc.Allocation(
        A={n: dict(r) for n, r in a1.A.items()}, unmet=dict(a1.unmet),
        bw_after=dict(a1.bw_after), bw_charge=dict(a1.bw_charge))
    merged.merge(a2)
    obs.append(_fields(merged))
    obs.append(p.check_ledger([_holdings(merged, need)], [merged.bw_charge],
                              strict=False))
    # a stale commit (the same allocation twice) and a double release
    obs.append(_error(lambda: pkg.alloc.commit(p, a1, need)))
    obs.append(p.snapshot())
    obs.append(_error(lambda: pkg.alloc.release(p, merged, need, t_s)))
    obs.append(p.snapshot())
    obs.append(p.check_ledger(strict=False))
    obs.append(_error(lambda: pkg.alloc.release(p, merged, need)))
    obs.append(p.snapshot())
    return obs


@pytest.mark.parametrize("block", range(4))
def test_random_pools_equal_reference(block):
    """200 seeded pools and chains (50 per block): every observable of the
    resource_alloc -> commit -> check_ledger -> release script is equal."""
    nonempty = 0
    for seed in range(50 * block, 50 * (block + 1)):
        case = _draw_case(np.random.default_rng(seed))
        got, want = _run_case(PORT, case), _run_case(REF, case)
        assert got == want, f"seed {seed}"
        nonempty += any(any(r.values()) for r in got[3][0].values())
    assert nonempty >= 25          # most draws place something


def test_strict_ledger_errors_equal_reference():
    """NicState's strict takes and gives and Pool.mark_gray refuse with the
    reference's messages, character for character."""
    def script(pkg):
        spec = pkg.pool.NicSpec("n0", "bf2", 4, {"regex": 1}, 10.0)
        p = pkg.pool.Pool([spec])
        st_ = p["n0"]
        calls = [lambda: st_.take("cpu", 5), lambda: st_.give("cpu", 1),
                 lambda: st_.take("regex", 2), lambda: st_.give("crypto", 1),
                 lambda: st_.take_bw(10.5), lambda: st_.give_bw(0.25),
                 lambda: st_.take_bw(10.0 + 1e-7), lambda: st_.take_bw(-3.0),
                 lambda: st_.give_bw(10.0 + 1e-7),
                 lambda: p.mark_gray("n0", 0.0),
                 lambda: p.mark_gray("n0", 1.5), lambda: p.mark_gray("n0", 0.5)]
        out = [_error(c) for c in calls]
        p.set_usage("t", {"cpu": 2, "regex": 0})
        p.set_quota("t", max_units=3, max_gbps=2.5, weight=2)
        out += [p.snapshot(), p.usage_snapshot(), p.quota_row("t"),
                p.reserved_units(), p.reserved_units("t"),
                p.utilization("cpu"), p.capacity_frac(["n0"])]
        p.mark_failed("n0")
        out += [p.names(), p.total("cpu"), p.free_total("cpu"),
                p.utilization("cpu")]
        p.revive("n0")
        out += [p["n0"].gray_frac, p.names()]
        return out
    assert script(PORT) == script(REF)


@pytest.mark.parametrize("fn,kw", [
    ("paper_cluster", {}), ("paper_cluster", dict(racks=3, n_bf1=5)),
    ("paper_cluster", dict(n_bf2=1, n_bf1=0, n_pensando=1, racks=0)),
    ("tpu_pod_pool", {}), ("tpu_pod_pool", dict(groups=5,
                                                chips_per_group=4))])
def test_named_pools_equal_reference(fn, kw):
    got, want = getattr(pool, fn)(**kw), getattr(jpool, fn)(**kw)
    assert [_spec_tuple(s.spec) for s in got.nics.values()] == \
        [_spec_tuple(s.spec) for s in want.nics.values()]
    assert got.snapshot() == want.snapshot()


def _spec_tuple(spec):
    return (spec.name, spec.kind, spec.cores, spec.accelerators,
            spec.bandwidth_gbps, spec.core_mem_gb, spec.rack)
