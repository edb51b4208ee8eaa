"""Port apps and traffic held against the JAX package.

Seeded traffic must be byte-identical, and every app's ``run_pipeline``
must equal the reference's (``ALL_APPS(impl="ref")``) leaf for leaf: all
integer, bool and byte leaves bit for bit (tolerance 0). The one float
quantity on the path, ddos_check's float32 entropy margin, only decides a
bool mask; the test asserts the masks are equal AND that every seeded
packet's margin lies more than 1e-4 from the threshold, so a flipped
packet would be a real fault, not rounding (the margins themselves agree
within 1e-5: log2 may differ by an ulp and the 16-bin sums may be taken in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as JALL_APPS
from repro.apps import nf as jnf
from repro.apps import synth_packets as jsynth
from repro.apps.packets import pareto_flow_weights as jpareto
from repro.apps.packets import synth_packets_weighted as jsynth_weighted
from repro.core.graph import run_pipeline as jrun_pipeline
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.apps import ALL_APPS, app_resources, nf, synth_packets
from repro_torch.apps.packets import (pareto_flow_weights,
                                      synth_packets_weighted)
from repro_torch.core.graph import run_pipeline

APPS = ["ID", "ICG", "ISG", "FW", "FM", "LLB"]


def _assert_leaves_equal(ours, theirs):
    a = convert.leaves_to_numpy(ours)
    b = [np.asarray(x) for x in jax.tree.leaves(theirs)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("batch,flows,seed,pkt_bytes", [
    (48, 6, 3, 256), (96, 12, 7, 128), (20, 1, 0, 64), (8, 3, 11, 1500)])
def test_synth_packets_byte_identical(batch, flows, seed, pkt_bytes):
    ours = synth_packets(batch=batch, num_flows=flows, seed=seed,
                         pkt_bytes=pkt_bytes, device="cpu")
    _assert_leaves_equal(ours, jsynth(batch=batch, num_flows=flows, seed=seed,
                                      pkt_bytes=pkt_bytes))


def test_weighted_traffic_byte_identical():
    w = pareto_flow_weights(300, 1.2, seed=7)
    np.testing.assert_array_equal(w, jpareto(300, 1.2, seed=7))
    kw = dict(batch=96, num_flows=300, weights=w, seed=(7, 0, 3),
              pkt_bytes=64, flow_base=33)
    _assert_leaves_equal(synth_packets_weighted(device="cpu", **kw),
                         jsynth_weighted(**kw))


TRAFFIC = {"small": dict(batch=48, num_flows=6, seed=3, pkt_bytes=256),
           "wide": dict(batch=96, num_flows=40, seed=5, pkt_bytes=200)}


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
@pytest.mark.parametrize("name", APPS)
def test_run_pipeline_equals_reference(name, traffic):
    kw = TRAFFIC[traffic]
    want = jrun_pipeline(JALL_APPS(impl="ref")[name], jsynth(**kw))
    got = run_pipeline(ALL_APPS()[name], synth_packets(device="cpu", **kw))
    _assert_leaves_equal(got, want)
    forced = run_pipeline(ALL_APPS(impl="torch")[name],
                          synth_packets(device="cpu", **kw))
    _assert_leaves_equal(forced, want)


def _low_entropy_rows(rng, B, L):
    pay = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    pay[0] = 65                                  # constant payload
    pay[1, : L // 2] = 7
    pay[2] = np.tile(np.arange(16, dtype=np.uint8) * 16, L // 16 + 1)[:L]
    return pay


@pytest.mark.parametrize("B,L", [(96, 256), (8, 1500)])
def test_ddos_margin_masks_equal_and_far_from_threshold(B, L):
    rng = np.random.default_rng(L)
    pay = _low_entropy_rows(rng, B, L)
    length = np.full(B, L, np.int32)
    five = np.zeros((B, 5), np.int32)
    tb = convert.packet_batch(pay, length, five, device="cpu")
    jb = jnf.PacketBatch(payload=jnp.asarray(pay), length=jnp.asarray(length),
                         five_tuple=jnp.asarray(five),
                         mask=jnp.ones(B, bool), meta={})
    h1 = jnf._byte_hist(jb.payload[:, :750])
    h2 = jnf._byte_hist(jb.payload[:, 750:])
    jmargin = np.asarray(jnf._entropy(h1) + jnf._entropy(h2)
                         - jnf._entropy((h1 + h2) / 2.0))
    margin = nf.ddos_margin(tb).numpy()
    assert margin.dtype == np.float32
    np.testing.assert_allclose(margin, jmargin, rtol=0, atol=1e-5)
    assert np.all(np.abs(margin - nf.DDOS_THRESHOLD) > 1e-4)
    np.testing.assert_array_equal(nf.ddos_check(tb).numpy(),
                                  np.asarray(jnf.ddos_check(jb)))
    # the histograms themselves are exact (integer counts, one division)
    np.testing.assert_array_equal(nf._byte_hist(tb.payload[:, :750]).numpy(),
                                  np.asarray(h1))
    assert not bool(nf.ddos_check(tb)[0])        # the flood row is dropped


def test_llb_hmac_wraps_uint32():
    pay = np.full((4, 64), 255, np.uint8)
    pay[1] = 0
    pay[2, ::2] = 1
    length = np.full(4, 64, np.int32)
    five = np.zeros((4, 5), np.int32)
    got = run_pipeline(ALL_APPS()["LLB"],
                       convert.packet_batch(pay, length, five, device="cpu"))
    want = jrun_pipeline(JALL_APPS()["LLB"], jnf.PacketBatch(
        payload=jnp.asarray(pay), length=jnp.asarray(length),
        five_tuple=jnp.asarray(five), mask=jnp.ones(4, bool), meta={}))
    _assert_leaves_equal(got, want)
    assert got.meta["hmac"].dtype == torch.uint32


def test_apps_mirror_reference_stages_and_resources():
    ours, theirs = ALL_APPS(), JALL_APPS(impl="ref")
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        a, b = ours[name], theirs[name]
        assert a.name == b.name
        assert [(f.name, f.kind, f.resource, f.params) for f in a.stages] == [
            (f.name, f.kind, f.resource, f.params) for f in b.stages]
        assert app_resources(a) == sorted({f.resource for f in b.stages})
        assert sorted(a.state_decls) == sorted(b.state_decls)


def test_accel_state_carries_across():
    app = ALL_APPS()["ISG"]
    state = convert.accel_state(app)
    table, out = jref.build_aho_corasick(jnf.SNORT_RULES)
    np.testing.assert_array_equal(state["url_check"]["table"], table)
    np.testing.assert_array_equal(state["url_check"]["out_count"], out)
    np.testing.assert_array_equal(state["sha"]["key"], [7, 11, 13, 17])
    np.testing.assert_array_equal(state["aes"]["key"], [1, 2, 3, 4])
    # loading other constants changes what the stage computes
    other = ALL_APPS()["ISG"]
    t2, o2 = jref.build_aho_corasick(["zz"])
    convert.load_accel_state(other, {"url_check": {"table": t2,
                                                   "out_count": o2},
                                     "aes": {"key": [9, 9, 9, 9]}})
    assert convert.accel_state(other)["aes"]["key"].dtype == np.uint32
    b = synth_packets(batch=16, num_flows=2, pkt_bytes=64, device="cpu")
    assert not torch.equal(run_pipeline(app, b).payload,
                           run_pipeline(other, b).payload)
    convert.load_accel_state(other, state)
    _assert_leaves_equal(run_pipeline(other, b), jrun_pipeline(
        JALL_APPS(impl="ref")["ISG"], jsynth(batch=16, num_flows=2,
                                             pkt_bytes=64)))


def test_batch_numpy_round_trip():
    b = run_pipeline(ALL_APPS()["ISG"], synth_packets(
        batch=16, num_flows=3, pkt_bytes=64, device="cpu"))
    arrays = convert.batch_to_numpy(b)
    assert list(arrays)[:4] == ["payload", "length", "five_tuple", "mask"]
    meta = {k[len("meta."):]: v for k, v in arrays.items()
            if k.startswith("meta.")}
    back = convert.packet_batch(arrays["payload"], arrays["length"],
                                arrays["five_tuple"], arrays["mask"], meta,
                                device="cpu")
    for x, y in zip(convert.leaves_to_numpy(back), convert.leaves_to_numpy(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
