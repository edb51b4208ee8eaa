"""The partitioned steps' placements and the dry run over meshes
(``launch/steps.py``'s shardings, ``launch/mesh.fake_mesh``,
``launch/roofline.collective_bytes``, ``launch/dryrun.py``'s ``single``
and ``multi`` kinds) against the JAX package's.

* Every parameter's, decode-cache leaf's and batch leaf's placements from
  ``build_shardings``, ``cache_shardings`` and ``batch_shardings`` for the
  dense and ssm families' five archs at full width on the (16, 16) and
  (2, 16, 16) meshes, under ``rules_for``, equal with ``==`` the
  placements of the reference's specs (its ``build_shardings``' tree of
  specs, each stacked leaf's first entry, the "layers" axis, dropped; its
  ``cache_shardings``' and ``batch_shardings``' as they are); the same
  for the MoE and hybrid families' three archs, with their AdamW moments
  (``opt_state_struct_and_sharding``); and for the encdec and vlm
  families' two archs (seamless's encoder and decoder stacks, its self
  and cross caches; llava's patches). On a fake (16, 16) DeviceMesh,
  ``Model.distribute`` places each parameter so.
* ``collective_bytes`` on a hand-built DTensor program on a fake (4, 2)
  mesh: each kind's bytes by the reference's conventions (an all-reduce
  or all-to-all counts its input, an all-gather its gathered output, a
  reduce-scatter its scattered output) and the axis each ran on; the
  port's own all-to-all and all-gather with their adjoints' (an
  all-to-all, a reduce-scatter) in the backward.
* The counterpart of ``tests/test_dryrun_small.py::test_dryrun_small_mesh``
  on a fake (4, 2) mesh with the reference's assertions: reduced olmo-1b's
  train step traced partitioned (FLOPs > 0, collectives > 0), its decode
  step traced, the decomposition's roofline (dominant term one of three,
  0 < useful FLOPs ratio < 1.5, compute and memory terms > 0). The matmul
  FLOPs a device counts in the train step and in the prefill, times the 8
  devices, equal the one-device step's with ``==`` (a model-axis rank
  repeats none of them); on one device the counter's matmul FLOPs are
  ``FlopCounterMode``'s (whose count of a DTensor program mixes global
  and local shapes, so it is not a device's).
* One production cell traced on meta: olmo-1b train_4k over the fake
  (16, 16) mesh.
* Which cells the dry run partitions: every cell of every family, on
  both meshes, those whose rules split a sequence or a decode cache over
  the model axis through sequence-parallel attention and decode; two of
  them traced on meta with their K/V and state gathers counted.
"""
import functools
import math

import jax
import pytest
import torch
from torch.distributed.tensor import Shard
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.models import build as jbuild
from repro.parallel import sharding as jsh
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, ShapeConfig, cells
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.decompose import decompose_cell
from repro_torch.launch.mesh import MeshShape, fake_mesh, make_production_mesh
from repro_torch.launch.steps import (batch_shardings, build_shardings,
                                      cache_shardings,
                                      opt_state_struct_and_sharding)
from repro_torch.models.registry import build
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as tsh

ARCHS = ("olmo-1b", "gemma3-1b", "minicpm-2b", "qwen2.5-32b", "mamba2-370m")
MOE_ARCHS = ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
             "jamba-1.5-large-398b")
ENC_VLM_ARCHS = ("seamless-m4t-medium", "llava-next-34b")
MESHES = ("single", "multi")


def _desc(mk):
    return make_production_mesh(multi_pod=mk == "multi")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's parameter shapes and axes (its init traced), and
    its decode_32k cache's."""
    model = jbuild(jget_arch(arch))
    box = {}

    def init():
        p, a = model.init(jax.random.PRNGKey(0), jax.numpy.bfloat16)
        box["axes"] = a
        return p
    shapes = jax.eval_shape(init)
    c_struct, c_axes = model.cache_struct(JSHAPES["decode_32k"])
    return model, shapes, box["axes"], c_struct, c_axes


def _ref_leaf(tree, name, arch):
    from test_torch_sharding import _ref_param_leaf
    return _ref_param_leaf(tree, name, get_arch(arch))


@pytest.mark.parametrize("mk", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_reference(arch, mk):
    _placements_equal_reference(arch, mk)


@pytest.mark.parametrize("mk", MESHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_and_hybrid_placements_equal_reference(arch, mk):
    """The MoE and hybrid families' parameters (the experts' weights split
    over their experts and FSDP'd), AdamW moments and decode caches (the
    hybrid's mamba state beside its KV) on both production meshes, as
    the five archs' above; the moments in the config's dtype (bf16 for
    jamba), placed as the parameters."""
    _placements_equal_reference(arch, mk)
    desc = _desc(mk)
    cfg = get_arch(arch)
    model = build(cfg, "cpu")
    rules = tsh.rules_for(cfg, desc)
    struct, placed, _ = build_shardings(model, desc, rules)
    o_struct, o_placed = opt_state_struct_and_sharding(model, desc, placed,
                                                       struct)
    jmodel, shapes, axes, _, _ = _reference(arch)
    want_dtype = torch.bfloat16 if cfg.bf16_optimizer_state else \
        torch.float32
    assert cfg.bf16_optimizer_state == (arch == "jamba-1.5-large-398b")
    for name, t in struct.named_parameters():
        ref_a = _ref_leaf(axes, name, arch)
        ref_s = _ref_leaf(shapes, name, arch).shape
        if _stacked(name):
            ref_a, ref_s = ref_a[1:], ref_s[1:]
        want = tsh.placements(tsh.PartitionSpec(
            *jsh.spec_for(ref_a, ref_s, rules, desc)), desc)
        for m in ("mu", "nu"):
            assert getattr(o_placed, m)[name] == want, (m, name)
            assert getattr(o_struct, m)[name].dtype == want_dtype
            assert tuple(getattr(o_struct, m)[name].shape) == tuple(ref_s)
    experts = [n for n, _ in struct.named_parameters()
               if n.endswith(("moe.gate", "moe.up", "moe.down"))]
    assert experts
    for name in experts:
        assert placed[name][list(desc.axis_names).index("model")] == \
            Shard(0), name


@pytest.mark.parametrize("mk", MESHES)
@pytest.mark.parametrize("arch", ENC_VLM_ARCHS)
def test_encdec_and_vlm_placements_equal_reference(arch, mk):
    """seamless's encoder and decoder layers (their ``attn``, ``self``,
    ``cross`` and ``mlp`` blocks), its self and cross caches and its
    frames, and llava's layers, untied head and patches, on both
    production meshes, as the five archs' above."""
    _placements_equal_reference(arch, mk)


def _stacked(name):
    """Whether the reference stacks the parameter's leaf over layers."""
    return name.startswith(("segments.", "enc.", "dec."))


def _placements_equal_reference(arch, mk):
    desc = _desc(mk)
    cfg = get_arch(arch)
    model = build(cfg, "cpu")
    rules = tsh.rules_for(cfg, desc)
    jmodel, shapes, axes, c_struct, c_axes = _reference(arch)
    assert rules == jsh.rules_for(jget_arch(arch), desc)
    struct, placed, p_axes = build_shardings(model, desc, rules)
    for name, t in struct.named_parameters():
        ref_a = _ref_leaf(axes, name, arch)
        ref_s = _ref_leaf(shapes, name, arch).shape
        if _stacked(name):
            ref_a, ref_s = ref_a[1:], ref_s[1:]
        want = jsh.spec_for(ref_a, ref_s, rules, desc)
        assert placed[name] == tsh.placements(tsh.PartitionSpec(*want),
                                              desc), name
    c_struct_t, c_placed = cache_shardings(model, SHAPES["decode_32k"],
                                           desc, rules)
    for key, t in c_struct_t.items():
        if key.startswith("segments."):
            _, i, j, leaf = key.split(".")
            ref_t = c_struct["segments"][int(i)][int(j)][leaf]
            ref_a = c_axes["segments"][int(i)][int(j)][leaf]
        else:
            ref_t, ref_a = c_struct[key], c_axes[key]
        want = jsh.spec_for(ref_a, ref_t.shape, rules, desc)
        assert tuple(t.shape) == tuple(ref_t.shape)
        assert c_placed[key] == tsh.placements(tsh.PartitionSpec(*want),
                                               desc), key
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        specs, b_placed = batch_shardings(model, SHAPES[shape], desc, rules)
        j_sd, j_axes = jmodel.input_specs(JSHAPES[shape])
        assert set(specs) == set(j_sd)
        for k, t in specs.items():
            want = jsh.spec_for(j_axes[k], j_sd[k].shape, rules, desc)
            assert tuple(t.shape) == tuple(j_sd[k].shape)
            assert b_placed[k] == tsh.placements(tsh.PartitionSpec(*want),
                                                 desc), (shape, k)


def test_collective_bytes_follow_the_reference_conventions():
    """A (4, 2) program on meta: each redistribution's bytes by kind and
    axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with fake_mesh(MeshShape(("data", "model"), (4, 2))) as mesh:
        local = torch.empty((8, 6), dtype=torch.float32, device="meta")
        n = 8 * 6 * 4                               # one block's bytes

        def d(placements):
            return DTensor.from_local(local, mesh, placements,
                                      run_check=False)
        with rl.collective_bytes(mesh) as c:
            d([Replicate(), Shard(0)]).redistribute(
                mesh, [Replicate(), Replicate()])            # all-gather
        assert c.result["all-gather"] == 2 * n
        assert c.result["by_axis"] == {"model": 2 * n}
        with rl.collective_bytes(mesh) as c:
            d([Partial(), Replicate()]).redistribute(
                mesh, [Replicate(), Replicate()])            # all-reduce
        assert c.result["all-reduce"] == n
        assert c.result["by_axis"] == {"data": n}
        with rl.collective_bytes(mesh) as c:
            d([Partial(), Replicate()]).redistribute(
                mesh, [Shard(0), Replicate()])              # reduce-scatter
        assert c.result["reduce-scatter"] == n // 4
        # DTensor's CPU groups have no all-to-all: a reshard gathers
        with rl.collective_bytes(mesh) as c:
            d([Replicate(), Shard(0)]).redistribute(
                mesh, [Replicate(), Shard(1)])
        assert c.result["all-gather"] == 2 * n
        with rl.collective_bytes(mesh) as c:                # all-to-all
            torch.ops._c10d_functional.all_to_all_single(
                local, [4, 4], [4, 4], mesh.get_group(1).group_name)
        assert c.result["all-to-all"] == n
        assert c.result["count"] == 1
        assert c.result["total"] == c.result["by_axis"]["model"] == n
        assert c.result["collective-permute"] == 0
        # the port's all-to-all and its adjoint, and a tiled all-gather's
        # adjoint, a reduce-scatter: both directions booked by axis
        x = torch.empty((8, 6), device="meta", requires_grad=True)
        with rl.collective_bytes(mesh) as c:
            y = coll.all_to_all(x, mesh, "model", 0, 1)
            y.backward(torch.empty_like(y))
        assert c.result["all-to-all"] == 2 * n
        assert c.result["by_axis"] == {"model": 2 * n}
        assert c.result["count"] == 2
        with rl.collective_bytes(mesh) as c:
            y = coll.all_gather(x, mesh, "data", 1)
            y.backward(torch.empty_like(y))
        assert c.result["all-gather"] == 4 * n
        assert c.result["reduce-scatter"] == n
        assert c.result["by_axis"] == {"data": 5 * n}


SMALL = MeshShape(("data", "model"), (4, 2))


def test_dryrun_small_mesh_partitioned():
    """``test_dryrun_small_mesh``'s mechanics and assertions on the port:
    reduced olmo-1b over a fake (4, 2) mesh under ``default_rules``."""
    cfg = get_arch("olmo-1b").reduced()
    model = build(cfg, "meta")
    rules = tsh.default_rules()
    train = ShapeConfig("t", 512, 8, "train")
    with fake_mesh(SMALL) as mesh:
        fn, hold, _ = dryrun.step_call(model, train, mesh=mesh, rules=rules)
        with rl.collective_bytes(mesh) as coll:
            rec = rl.trace(fn, hold=hold)
        assert rec["flops"] > 0
        assert coll.result["total"] > 0              # real collectives
        fn, hold, _ = dryrun.step_call(model, ShapeConfig("d", 256, 8,
                                                          "decode"),
                                       mesh=mesh, rules=rules)
        lg, _ = fn()
        assert tuple(lg.shape) == (8, 512)
        dec = decompose_cell(model, train, mesh, rules)
    r = dec["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert 0.0 < r["useful_flops_ratio"] < 1.5
    assert r["t_compute"] > 0 and r["t_memory"] > 0
    assert r["t_collective"] > 0 and r["chips"] == 8
    assert sum(p["coll"]["total"] * p["mult"]
               for p in dec["pieces"].values()) > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_matmul_flops_per_device_times_devices_equal_one_device(kind):
    cfg = get_arch("olmo-1b").reduced()
    model = build(cfg, "meta")
    shape = ShapeConfig("s", 512, 8, kind)
    fn, _, _ = dryrun.step_call(model, shape, dtype=torch.float32)
    one = rl.trace(fn)
    with FlopCounterMode(display=False) as f1:
        fn()
    with fake_mesh(SMALL) as mesh:
        fn, _, _ = dryrun.step_call(model, shape, dtype=torch.float32,
                                    mesh=mesh, rules=tsh.default_rules())
        dev = rl.trace(fn)
    assert f1.get_total_flops() == one["aten_flops"] > 0
    assert dev["aten_flops"] * 8 == one["aten_flops"]
    assert dev["kernel_flops"] * 8 == one["kernel_flops"] > 0
    for name, k in one["kernels"].items():
        assert dev["kernels"][name]["launches"] == k["launches"]


def test_production_cell_traced_on_meta():
    """olmo-1b train_4k over the fake (16, 16) mesh: a device's step, its
    collectives on both axes, the roofline's collective term from the
    H100 link rates, and the parameters placed by the resolver."""
    rec = dryrun.run_cell("olmo-1b", "train_4k", "single", device="cpu",
                          verbose=False)
    assert "analytic" not in rec and rec["chips"] == 256
    coll = rec["collectives_full_step"]
    assert coll["total"] > 0 and set(coll["by_axis"]) == {"data", "model"}
    roof = rec["roofline"]
    assert roof["coll_bytes_per_device"] == coll["total"]
    assert roof["link_bw"] == {"data": 50e9, "model": 50e9}
    assert roof["t_collective"] == pytest.approx(
        sum(b / 50e9 for b in coll["by_axis"].values()))
    assert rec["memory"]["held_bytes"] >= \
        rec["memory"]["arguments"]["params"]
    assert rec["memory"]["fits"] and rec["step"]["kernels"]
    model = build(get_arch("olmo-1b"), "meta")
    desc = make_production_mesh()
    rules = tsh.rules_for(model.cfg, desc)
    _, want, _ = build_shardings(model, desc, rules)
    with fake_mesh(desc) as mesh:
        params = model.distribute(model.param_struct(), mesh, rules)
        for name, p in params.named_parameters():
            assert tuple(p.placements) == want[name], name


@pytest.mark.parametrize("arch,shape", [
    ("seamless-m4t-medium", "prefill_32k"),
    ("seamless-m4t-medium", "decode_32k"), ("llava-next-34b", "train_4k")])
def test_encdec_and_vlm_cells_traced_on_meta(arch, shape):
    """seamless's prefill (encoder and decoder, cross-attention over the
    placed encoder output) and decode (self and cross caches placed), and
    llava's train step (placed patches ahead of the tokens), each traced
    over the fake (16, 16) mesh: a device's step with its collectives and
    kernels."""
    rec = dryrun.run_cell(arch, shape, "single", device="cpu",
                          verbose=False)
    assert "analytic" not in rec and rec["chips"] == 256
    assert rec["collectives_full_step"]["total"] > 0
    assert rec["step"]["flops"] > 0 and rec["step"]["kernels"]
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["held_bytes"] > 0


def _gathered(n_layers, shape, *dims, itemsize=2):
    """Bytes of ``n_layers`` all-gathers of tensors of ``shape`` over the
    16-way model axis, each counted as its gathered output (the
    reference's convention), per tensor of ``dims``."""
    return n_layers * len(dims) * 16 * math.prod(shape) * itemsize


def test_sequence_split_cells_traced_with_their_gathers():
    """qwen2.5-32b's prefill_32k on the (16, 16) mesh (dp_heavy: 32 rows
    over data, 2 a device, each sequence over the model axis in blocks of
    2,048) gathers each layer's K and V, (2, 2,048, 8, 128) bf16 a device,
    over the model axis: 64 x 2 x 134 MB (17.2 GB) of its collectives
    there. jamba's long_500k (one row; the 524,288-row cache over the
    model axis) merges each of its 9 attention layers' decode partials,
    out (1, 64, 128) and lse (1, 64) f32 a device, over the model axis.
    Both run the kernels on each device's block."""
    q = dryrun.run_cell("qwen2.5-32b", "prefill_32k", "single",
                        device="cpu", verbose=False)
    cfg = get_arch("qwen2.5-32b")
    kv = _gathered(cfg.n_layers, (2, 2048, cfg.n_kv_heads, cfg.head_dim),
                   "k", "v")
    assert kv == 64 * 2 * 16 * 2 * 2048 * 8 * 128 * 2
    assert q["collectives_full_step"]["by_axis"]["model"] >= kv
    assert q["step"]["kernels"]["flash_attention"]["launches"] == \
        cfg.n_layers
    j = dryrun.run_cell("jamba-1.5-large-398b", "long_500k", "single",
                        device="cpu", verbose=False)
    cfg = get_arch("jamba-1.5-large-398b")
    n_attn = cfg.n_layers // cfg.attn_period
    partials = _gathered(n_attn, (1, cfg.n_heads, cfg.head_dim), "out",
                         itemsize=4) + _gathered(n_attn, (1, cfg.n_heads),
                                                 "lse", itemsize=4)
    assert j["collectives_full_step"]["by_axis"]["model"] >= partials
    assert j["step"]["kernels"]["decode_attention"]["launches"] == n_attn
    for rec in (q, j):
        assert "analytic" not in rec and rec["memory"]["fits"]


def _partitioned(arch, shape, mk):
    model = build(get_arch(arch), "meta")
    desc = _desc(mk)
    return dryrun.partition_reason(model, SHAPES[shape], desc,
                                   tsh.rules_for(model.cfg, desc))


@pytest.mark.parametrize("mk", MESHES)
def test_partitioned_cells_are_the_rules_whole_sequence_cells(mk):
    """Every cell of every arch is traced partitioned on both meshes:
    where the rules split a sequence or a decode cache over the model
    axis, through sequence-parallel attention and decode. phi3.5-moe's
    train_4k (the sequence over the model axis under the table for kv
    heads that do not divide it) is traced: its record holds a device's
    step and its collectives on both axes."""
    for arch in ARCHS + MOE_ARCHS + ENC_VLM_ARCHS:
        for _, shape in cells(arch):
            assert _partitioned(arch, shape, mk) is None, (arch, shape)
    rec = dryrun.run_cell("phi3.5-moe-42b-a6.6b", "train_4k", mk,
                          verbose=False)
    assert "analytic" not in rec and "reason" not in rec
    assert rec["step"]["kernels"]["flash_attention"]["launches"] > 0
    assert set(rec["collectives_full_step"]["by_axis"]) >= {"data", "model"}
