"""The port's sharding resolver (``repro_torch.parallel.sharding``) and mesh
descriptions (``repro_torch.launch.mesh``) held against the JAX package's.

* Every case of ``tests/test_sharding.py`` on the port, the two hypothesis
  properties included; the reference's one-device ``jax.make_mesh`` meshes
  become mesh descriptions of the same axis sizes, and one case runs on a
  ``torch.distributed`` DeviceMesh.
* For all ten architectures at full width, on fake (16, 16) and
  (2, 16, 16) meshes, under ``rules_for``, ``default_rules(False)`` and
  ``dp_heavy_rules``: every parameter's spec equals the reference leaf's
  with its leading ``"layers"`` entry dropped (the port unstacks the
  reference's layer stacks; that axis resolves to nothing in every table),
  and every decode-cache leaf's spec at ``decode_32k`` equals the
  reference's as it is (the port's cache keeps the stacked layout).
  The reference's shapes come from ``Model.param_struct``'s
  ``jax.eval_shape`` of its init and ``cache_struct``; its axes are the
  tree that the same traced init returns (the reference's ``_axes_tree``
  builds that tree again from an eagerly run tiny config, which is
  checked equal for olmo-1b).
* ``batch_dp_degree``, ``dp_degree`` and DTensor placements.
"""
import functools
import socket

import jax
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.launch import mesh as jmesh
from repro.models import build as jbuild
from repro.parallel import sharding as jsh
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.models.registry import build, cache_leaves
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.sharding import (PartitionSpec, default_rules,
                                           spec_for)


class _FakeMesh:
    """Minimal mesh stand-in (the reference test's), read by both
    packages' resolvers."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def _host(sizes):
    return _FakeMesh(sizes)


# -- test_sharding.py's cases ------------------------------------------------------

def test_heads_take_model_axis_when_divisible():
    mesh = tmesh.make_host_mesh()
    spec = spec_for(("embed", "heads", "head_dim"), (512, 16, 64),
                    default_rules(), mesh)
    assert spec == PartitionSpec("data", "model", None)


def test_no_head_dim_fallback_by_default():
    mesh = _FakeMesh({"data": 16, "model": 16})
    spec = spec_for(("embed", "heads", "head_dim"), (512, 36, 64),
                    default_rules(), mesh)
    assert spec[1] is None and spec[2] is None


def test_batch_uses_pod_and_data_jointly():
    mesh = _host({"pod": 1, "data": 1, "model": 1})
    spec = spec_for(("batch", "seq"), (256, 4096), default_rules(), mesh)
    assert spec == PartitionSpec(("pod", "data"), None)


def test_kv_heads_priority_over_kv_seq():
    mesh = tmesh.make_host_mesh()
    spec = spec_for(("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                    (16, 128, 32768, 16, 128), default_rules(), mesh)
    assert spec[3] == "model"
    assert spec[2] is None


def test_unknown_axis_replicates():
    mesh = tmesh.make_host_mesh()
    spec = spec_for(("mystery", None), (7, 3), default_rules(), mesh)
    assert spec == PartitionSpec(None, None)


def test_no_fsdp_rules():
    mesh = tmesh.make_host_mesh()
    spec = spec_for(("vocab", "embed"), (50304, 2048), default_rules(False),
                    mesh)
    assert spec == PartitionSpec("model", None)


def test_divisibility_respected_fake_mesh():
    mesh = _FakeMesh({"data": 16, "model": 16})
    rules = default_rules()
    spec = spec_for(("embed", "heads", "head_dim"), (2304, 36, 64), rules,
                    mesh)
    assert spec == PartitionSpec("data", None, None)
    spec = spec_for(("vocab", "embed"), (256206, 1024), rules, mesh)
    assert spec == PartitionSpec(None, "data")


def test_batch_fallback_to_data_only_fake_mesh():
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    spec = spec_for(("batch", "seq"), (16, 128), default_rules(), mesh)
    assert spec == PartitionSpec("data", None)


@given(st.integers(1, 64), st.integers(1, 64), st.integers(1, 8),
       st.integers(1, 8))
@settings(max_examples=200, deadline=None)
def test_property_spec_always_divides(d1, d2, m1, m2):
    mesh = _FakeMesh({"data": m1, "model": m2})
    spec = spec_for(("embed", "ff"), (d1, d2), default_rules(), mesh)
    for dim, s in zip((d1, d2), spec):
        if s is None:
            continue
        axes = (s,) if isinstance(s, str) else s
        size = int(np.prod([mesh.shape[a] for a in axes]))
        assert dim % size == 0
    assert spec == jsh.spec_for(("embed", "ff"), (d1, d2),
                                jsh.default_rules(), mesh)


@given(st.integers(1, 8), st.integers(1, 8))
@settings(max_examples=100, deadline=None)
def test_property_no_axis_used_twice(m1, m2):
    mesh = _FakeMesh({"data": m1, "model": m2})
    shape = (m1 * m2 * 4, m2 * 2, m2 * 2, m2 * 2)
    axes = ("embed", "heads", "head_dim", "ff")
    spec = spec_for(axes, shape, default_rules(), mesh)
    used = []
    for s in spec:
        if s is None:
            continue
        used.extend((s,) if isinstance(s, str) else s)
    assert len(used) == len(set(used))
    assert spec == jsh.spec_for(axes, shape, jsh.default_rules(), mesh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_device_mesh_resolves_as_a_description():
    """A one-rank gloo DeviceMesh of (1, 1): its names and sizes resolve
    as the (1, 1) description does, and placements are built from it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        dm = init_device_mesh("cpu", (1, 1),
                              mesh_dim_names=("data", "model"))
        assert tsh.mesh_axes(dm) == {"data": 1, "model": 1}
        spec = spec_for(("embed", "heads", "head_dim"), (512, 16, 64),
                        default_rules(), dm)
        assert spec == PartitionSpec("data", "model", None)
        assert tsh.placements(spec, dm) == (Shard(0), Shard(1))
        assert tsh.placements(PartitionSpec(None, None), dm) == (
            Replicate(), Replicate())
        x = torch.ones(3, 4)
        assert tsh.constrain(x, ("batch", None), default_rules(), dm) is x
    finally:
        dist.destroy_process_group()


def test_host_mesh_takes_min_of_model_and_world_as_reference():
    """Without a process group the port's world is the one card: any
    ``model`` resolves to min(model, 1), as the reference's does over this
    process's one CPU device, and no model size raises."""
    for model in (1, 2, 16):
        got = tmesh.make_host_mesh(model)
        want = jmesh.make_host_mesh(model)
        assert got.axis_names == tuple(want.axis_names) == ("data", "model")
        assert got.shape == dict(want.shape) == {"data": 1, "model": 1}


def test_host_mesh_with_a_group_is_a_device_mesh_over_the_world():
    """With a group initialised, ``make_host_mesh`` is a live DeviceMesh
    over the world (one gloo rank here; the expert-parallel tests build
    (2, 2), (1, 4) and (1, 2) worlds), which the activation context takes
    and on which ``constrain`` is the identity: each rank holds its block."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        dm = tmesh.make_host_mesh(4, device_type="cpu")
        assert tsh.is_live(dm) and dm.device_type == "cpu"
        assert tsh.mesh_axes(dm) == {"data": 1, "model": 1}
        assert tsh.coordinates(dm) == {"data": 0, "model": 0}
        x = torch.ones(2, 3, 8)
        tsh.set_activation_sharding(tsh.dp_heavy_rules(), dm, tokens=(2, 3))
        try:
            assert tsh.constrain_act(x, ("batch", "seq", None)) is x
            spec = PartitionSpec(("data", "model"), None, None)
            assert tsh.block(x, spec, dm).equal(x)
        finally:
            tsh.set_activation_sharding(None, None)
    finally:
        dist.destroy_process_group()


def test_constrain_is_identity_on_one_device_and_raises_on_more():
    x = torch.ones(4, 8)
    host = tmesh.make_host_mesh()
    assert tsh.constrain(x, ("batch", None), default_rules(), host) is x
    assert tsh.constrain(x, ("batch", None), default_rules(), None) is x
    tsh.set_activation_sharding(default_rules(), host)
    try:
        assert tsh.constrain_act(x, ("batch", None)) is x
    finally:
        tsh.set_activation_sharding(None, None)
    prod = tmesh.make_production_mesh()
    with pytest.raises(NotImplementedError):
        tsh.constrain(x, ("batch", None), default_rules(), prod)
    with pytest.raises(NotImplementedError):
        tsh.set_activation_sharding(default_rules(), prod)


# -- every parameter and cache leaf of the ten architectures -------------------------

MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
RULES = ("rules_for", "no_fsdp", "dp_heavy")


def _rules(pkg, which, cfg, mesh):
    if which == "rules_for":
        return pkg.rules_for(cfg, mesh)
    if which == "no_fsdp":
        return pkg.default_rules(False)
    return pkg.dp_heavy_rules()


def _is_axes_leaf(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's parameter shapes and axes (its init traced by
    ``jax.eval_shape``, nothing allocated), and its decode_32k cache's."""
    model = jbuild(jget_arch(arch))
    box = {}

    def init():
        p, a = model.init(jax.random.PRNGKey(0), jax.numpy.bfloat16)
        box["axes"] = a
        return p
    shapes = jax.eval_shape(init)
    c_struct, c_axes = model.cache_struct(JSHAPES["decode_32k"])
    return shapes, box["axes"], c_struct, c_axes


def _ref_param_leaf(tree, name, cfg):
    """The reference leaf of port parameter ``name``: ``segments.<s>.<l>.``
    maps to segment s's body position l % len(body), ``enc.<l>.`` and
    ``dec.<l>.`` to the stacks."""
    from repro_torch.models.lm import build_schedule
    parts = name.split(".")
    if parts[0] == "segments":
        si, li = int(parts[1]), int(parts[2])
        node = tree["segments"][si][li % len(build_schedule(cfg)[si].body)]
        rest = parts[3:]
    elif parts[0] in ("enc", "dec"):
        node, rest = tree[parts[0]], parts[2:]
    else:
        node, rest = tree, parts
    for p in rest:
        node = node[p]
    return node


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_specs_equal_reference(arch):
    assert set(ARCHS) == set(JARCHS)
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    shapes, axes, c_struct, c_axes = _reference(arch)
    model = build(cfg, "cpu")
    params = dict(model.param_struct().named_parameters())
    p_axes = model.param_axes()
    cache = cache_leaves(model.cache_struct(SHAPES["decode_32k"]))
    cache_ax = model.cache_axes()
    n = 0
    for mk, (names, sizes) in MESHES.items():
        mesh = _FakeMesh(dict(zip(names, sizes)))
        for which in RULES:
            rules = _rules(tsh, which, cfg, mesh)
            assert rules == _rules(jsh, which, jcfg, mesh)
            got = tsh.tree_specs(p_axes, params, rules, mesh)
            for name, t in params.items():
                ref_shape = _ref_param_leaf(shapes, name, cfg).shape
                ref_axes = _ref_param_leaf(axes, name, cfg)
                assert ref_axes[0] == "layers" or not name.startswith(
                    ("segments", "enc.", "dec."))
                if name.startswith(("segments", "enc.", "dec.")):
                    ref_axes, ref_shape = ref_axes[1:], ref_shape[1:]
                assert tuple(t.shape) == tuple(ref_shape), name
                assert p_axes[name] == ref_axes, name
                want = jsh.spec_for(ref_axes, ref_shape, rules, mesh)
                # the reference's spec of the stacked leaf, first entry
                # dropped, is the same thing
                full = jsh.spec_for(_ref_param_leaf(axes, name, cfg),
                                    _ref_param_leaf(shapes, name, cfg).shape,
                                    rules, mesh)
                if name.startswith(("segments", "enc.", "dec.")):
                    assert tuple(full)[0] is None
                    assert tuple(want) == tuple(full)[1:], name
                assert got[name] == want, (name, mk, which)
                n += 1
            got_c = tsh.tree_specs(cache_ax, cache, rules, mesh)
            for key, t in cache.items():
                parts = key.split(".")
                if parts[0] == "segments":
                    ref_t = c_struct["segments"][int(parts[1])][
                        int(parts[2])][parts[3]]
                    ref_a = c_axes["segments"][int(parts[1])][
                        int(parts[2])][parts[3]]
                else:
                    ref_t, ref_a = c_struct[key], c_axes[key]
                assert tuple(t.shape) == tuple(ref_t.shape), key
                assert cache_ax[key] == ref_a, key
                assert got_c[key] == jsh.spec_for(ref_a, ref_t.shape, rules,
                                                  mesh), (key, mk, which)
                n += 1
    assert n == 6 * (len(params) + len(cache))


def test_axes_tree_of_traced_init_equals_reference_axes_tree():
    _, axes, _, _ = _reference("olmo-1b")
    want = jbuild(jget_arch("olmo-1b")).param_struct()[1]
    assert jax.tree.leaves(axes, is_leaf=_is_axes_leaf) == \
        jax.tree.leaves(want, is_leaf=_is_axes_leaf)
    assert jax.tree.structure(axes, is_leaf=_is_axes_leaf) == \
        jax.tree.structure(want, is_leaf=_is_axes_leaf)


@pytest.mark.parametrize("mk", sorted(MESHES))
def test_dp_degrees_equal_reference(mk):
    names, sizes = MESHES[mk]
    mesh = _FakeMesh(dict(zip(names, sizes)))
    desc = tmesh.make_production_mesh(multi_pod=mk == "multi")
    assert desc.axis_names == names and tuple(desc.shape.values()) == sizes
    assert tmesh.dp_degree(desc) == jmesh.dp_degree(mesh)
    assert tmesh.dp_degree(tmesh.make_host_mesh()) == 1
    for arch in sorted(ARCHS):
        for shape in SHAPES.values():
            for which in RULES:
                rules = _rules(tsh, which, get_arch(arch), desc)
                for gb in (shape.global_batch, 1, 8, 24, 512):
                    assert tsh.batch_dp_degree(rules, desc, gb) == \
                        jsh.batch_dp_degree(rules, mesh, gb)


def test_shardings_for_gives_placements_of_each_spec():
    from torch.distributed.tensor import Replicate, Shard
    model = build(get_arch("olmo-1b"), "cpu")
    params = dict(model.param_struct().named_parameters())
    mesh = tmesh.make_production_mesh()
    rules = default_rules()
    pl = tsh.shardings_for(model.param_axes(), params, rules, mesh)
    specs = tsh.tree_specs(model.param_axes(), params, rules, mesh)
    assert set(pl) == set(params)
    q = "segments.0.0.attn.q.w"
    assert specs[q] == PartitionSpec("data", "model", None)
    assert pl[q] == (Shard(0), Shard(1))
    assert pl["embed.table"] == (Replicate(), Shard(0))
