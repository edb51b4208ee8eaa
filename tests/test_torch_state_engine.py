"""The port's state engine (``repro_torch.core.state_engine``) held against
the JAX package's.

* Every case of ``test_state_engine.py`` runs on both packages; the port
  takes its sync inputs as tensors.
* A seeded script of ADD, SET, REMOVE, GET, TRAVERSE, COMPUTE and expiry
  over 4 engines with 4 buckets (collisions everywhere), under one fake
  clock per package: return values, ``Transport`` counters, ``version`` and
  table sizes equal.
* ``bounded_sync`` against the reference's numpy form, and the device form
  ``bounded_sync_deltas``: at P = 1 against the reference's ``shard_map``
  form, at P = 8 against the reference's host form (int64 bit-equal; f32
  within P · 2^-24 · Σ|delta|, each element's error bound when the P deltas
  are summed in another order), and its snapshot is a copy.
"""
import types

import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

from repro.core import state_engine as jse
from repro_torch.core import state_engine as se

PORT = types.SimpleNamespace(name="port", se=se, arr=torch.from_numpy)
REF = types.SimpleNamespace(name="ref", se=jse, arr=lambda a: a)
PKGS = (PORT, REF)
IDS = [p.name for p in PKGS]


def make_service(pkg, n=3):
    return pkg.se.StateService([f"nic{i}" for i in range(n)], buckets=64)


# -- test_state_engine.py's cases on both packages -----------------------------

@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_full_access_visible_everywhere(pkg):
    svc = make_service(pkg)
    svc.declare("ctr", pkg.se.FULL_ACCESS)
    svc.fstate_set("ctr", 42)
    for nic in svc.engines:
        assert svc.get("ctr", local=nic) == 42
    svc.fstate_remove("ctr")
    assert svc.get("ctr", local="nic0") is None


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_non_external_write_local_write_global_read(pkg):
    svc = make_service(pkg)
    svc.declare("x", pkg.se.NON_EXTERNAL_WRITE)
    svc.ne_set("x", 7, local="nic1")
    r0 = svc.transport.reads
    assert svc.get("x", local="nic0") == 7
    assert svc.transport.reads == r0 + 1
    r1 = svc.transport.reads
    assert svc.get("x", local="nic1") == 7
    assert svc.transport.reads == r1


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_traverse_pulls_tables_once(pkg):
    svc = make_service(pkg, n=4)
    for i, nic in enumerate(svc.engines):
        svc.ne_set(f"k{i}", i, local=nic)
    r0 = svc.transport.reads
    entries = svc.traverse(local="nic0")
    assert {e.s_name for e in entries} == {"k0", "k1", "k2", "k3"}
    assert svc.transport.reads == r0 + 3


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_compute_ships_instruction(pkg):
    svc = make_service(pkg)
    svc.fstate_set("v", 5)
    out = svc.compute("v", ucf=lambda vals: sum(vals), combine=sum)
    assert out == 15


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_expiry_lifespan(pkg):
    t = pkg.se.LinkedHashTable(buckets=8)
    t.put("a", 1, now=0.0)
    t.put("b", 2, now=400.0)
    assert t.expire(now=600.0, lifespan=500.0) == 1
    assert t.get("a") is None and t.get("b") is not None


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_hash_collisions_still_correct(pkg):
    t = pkg.se.LinkedHashTable(buckets=1)
    for i in range(50):
        t.put(f"key{i}", i)
    assert all(t.get(f"key{i}").value == i for i in range(50))
    assert t.remove("key25") and t.get("key25") is None
    assert t.size == 49


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_bounded_sync_counters_converge(pkg):
    values = pkg.arr(np.array([[5.0], [3.0], [0.0]]))
    snaps = pkg.arr(np.zeros((3, 1)))
    merged, snaps = pkg.se.bounded_sync(values, snaps)
    np.testing.assert_allclose(merged, [[8.0]] * 3)
    merged[0] += 2
    merged2, _ = pkg.se.bounded_sync(merged, snaps)
    np.testing.assert_allclose(merged2, [[10.0]] * 3)


def _sum_preserving(pkg, updates_per_round):
    P = len(updates_per_round[0])
    values = np.zeros((P, 1))
    total = 0.0
    for i, d in enumerate(updates_per_round[0][:P]):
        values[i] += d
        total += d
    values, _ = pkg.se.bounded_sync(pkg.arr(values), pkg.arr(np.zeros((P, 1))))
    np.testing.assert_allclose(values, total, atol=1e-6)
    return np.asarray(values)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
@given(st.lists(st.lists(st.floats(-100, 100), min_size=2, max_size=5),
                min_size=1, max_size=6))
@settings(max_examples=100, deadline=None)
def test_property_bounded_sync_sum_preserving(pkg, updates_per_round):
    got = _sum_preserving(pkg, updates_per_round)
    want = _sum_preserving(REF, updates_per_round)
    deltas = updates_per_round[0][:want.shape[0]]
    # f64 sums in another order: P + 2 roundings of at most Σ|delta| each
    bound = (len(deltas) + 2) * 2.0 ** -53 * sum(abs(d) for d in deltas)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def test_bounded_sync_device_form_at_p1_equals_shard_map():
    """The reference test's shard_map over a size-1 axis, against the
    port's sum over dimension 0 of the same (1, 1) replicas."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = jax.make_mesh((1,), ("p",))
    f = shard_map(lambda v, s: jse.bounded_sync_deltas(v, s, "p"), mesh=mesh,
                  in_specs=(P("p"), P("p")), out_specs=(P("p"), P("p")))
    v, s = np.array([[4.0]], np.float32), np.array([[1.0]], np.float32)
    want, want_snap = f(jnp.asarray(v), jnp.asarray(s))
    got, got_snap = se.bounded_sync_deltas(torch.from_numpy(v),
                                           torch.from_numpy(s), dim=0)
    assert float(got[0, 0]) == float(want[0, 0]) == 4.0
    np.testing.assert_array_equal(got_snap.numpy(), np.asarray(want_snap))


@pytest.mark.parametrize("dtype", ["int64", "float32"])
def test_bounded_sync_deltas_at_p8_equals_host_form(dtype):
    """Eight replicas of 4,096 per-slot counters through 6 rounds of seeded
    increments, each synced once: the device form against the reference's
    numpy host form on the same replicas and snapshots."""
    rng = np.random.default_rng(0)
    P, N = 8, 4096
    v = np.zeros((P, N), dtype)
    s = np.zeros((P, N), dtype)
    for _ in range(6):
        if dtype == "int64":
            v = v + rng.integers(0, 1 << 20, size=(P, N)).astype(dtype)
        else:
            v = v + rng.normal(0, 100, size=(P, N)).astype(dtype)
        got, got_snap = se.bounded_sync_deltas(torch.from_numpy(v),
                                               torch.from_numpy(s), dim=0)
        want, want_snap = jse.bounded_sync(v, s)
        if dtype == "int64":
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got_snap.numpy(), want_snap)
        else:
            bound = P * 2.0 ** -24 * np.abs(v - s).sum(axis=0, keepdims=True)
            assert np.all(np.abs(got.numpy() - want) <= bound)
        v, s = want, want_snap
    if dtype == "int64":                # every replica holds the global sum
        np.testing.assert_array_equal(v, np.broadcast_to(v[:1], (P, N)))


def test_bounded_sync_host_form_equals_reference():
    rng = np.random.default_rng(1)
    values = rng.integers(-1000, 1000, size=(5, 3, 7))
    snaps = rng.integers(-1000, 1000, size=(5, 3, 7))
    want_m, want_s = jse.bounded_sync(values, snaps)
    got_m, got_s = se.bounded_sync(torch.from_numpy(values),
                                   torch.from_numpy(snaps))
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_bounded_sync_snapshot_is_a_copy():
    v = torch.tensor([[5, 1], [3, 2]])
    merged, snap = se.bounded_sync_deltas(v, torch.zeros_like(v), dim=0)
    before = snap.clone()
    merged += 7
    assert torch.equal(snap, before)
    assert snap.data_ptr() != merged.data_ptr()
    merged, snap = se.bounded_sync(v, torch.zeros_like(v))
    merged[0] -= 1
    assert torch.equal(snap, before)


# -- a seeded script over both packages ----------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _value(rng, step):
    kind = step % 4
    if kind == 0:
        return int(rng.integers(0, 100))
    if kind == 1:
        return float(rng.normal())
    if kind == 2:
        return rng.integers(0, 9, size=int(rng.integers(1, 6))).astype(
            rng.choice(["int32", "int64", "float32"]))
    return [int(x) for x in rng.integers(0, 5, size=3)]


def _as_pkg(pkg, value):
    """An array value goes to the port as a tensor, as the port's data
    plane holds its state; anything else as it is."""
    if pkg is PORT and isinstance(value, np.ndarray):
        return torch.from_numpy(value)
    return value


def _plain(v):
    if isinstance(v, torch.Tensor):
        return ("array", str(v.dtype).split(".")[-1], v.tolist())
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.tolist())
    return v


def _script(pkg, seed, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(pkg.se, "time", types.SimpleNamespace(monotonic=clock))
    rng = np.random.default_rng(seed)
    nics = [f"nic{i}" for i in range(4)]
    svc = pkg.se.StateService(nics, buckets=4)
    names = [f"flow{i}" for i in range(12)]
    for n in names[:6]:
        svc.declare(n, pkg.se.FULL_ACCESS)
    for n in names[6:]:
        svc.declare(n, pkg.se.NON_EXTERNAL_WRITE)
    out = []
    for step in range(300):
        clock.t += float(rng.uniform(0, 40))
        op = int(rng.integers(0, 9))
        name = names[int(rng.integers(0, 12))]
        local = nics[int(rng.integers(0, 4))]
        value = _value(rng, step)
        if op == 0:
            svc.fstate_add(name, _as_pkg(pkg, value))
        elif op == 1:
            svc.fstate_set(name, _as_pkg(pkg, value))
        elif op == 2:
            svc.fstate_remove(name)
        elif op == 3:
            svc.ne_add(name, _as_pkg(pkg, value), local)
        elif op == 4:
            svc.ne_set(name, _as_pkg(pkg, value), local)
        elif op == 5:
            out.append(svc.ne_remove(name, local))
        elif op == 6:
            out.append(_plain(svc.get(name, local)))
        elif op == 7:
            out.append(sorted((e.s_name, e.h_key, e.s_len, e.lu_time)
                              for e in svc.traverse(local)))
        else:
            out.append(svc.compute(
                name, ucf=lambda vals: len(vals),
                combine=lambda parts: (sum(parts), len(parts))))
        if step % 50 == 49:
            out.append(svc.expire_all(clock.t + float(rng.uniform(0, 600))))
        tr = svc.transport
        out.append((tr.reads, tr.writes, tr.bytes_read, tr.bytes_written,
                    svc.version,
                    [e.table.size for e in svc.engines.values()]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_script_equals_reference(seed, monkeypatch):
    got = _script(PORT, seed, monkeypatch)
    want = _script(REF, seed, monkeypatch)
    assert got == want
    assert want[-1][2] > 0 and want[-1][3] > 0      # remote bytes moved


def test_hash_and_entry_bytes_equal_reference():
    for name in ["", "a", "flow_counters", "κλειδί", "x" * 100]:
        assert se._h_key(name) == jse._h_key(name)
    for v in [3, 2.5, [1, 2, 3], np.arange(7, dtype=np.int16)]:
        assert se._nbytes(v) == jse._nbytes(v)
    t = torch.arange(7, dtype=torch.int16)
    assert se._nbytes(t) == jse._nbytes(t.numpy()) == 14
    assert se.StateEntry("k", 1, torch.zeros(3, 5), 0.0).s_len == 60
