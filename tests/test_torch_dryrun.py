"""The port's launch tooling (``repro_torch.launch.{roofline,decompose,
dryrun,report}``) and the kernel-shaped branches it traces through.

* Per family (dense, vlm, MoE, ssm, hybrid, encdec) and kind (train,
  prefill, decode), at reduced configs: the decomposition's FLOPs equal
  the whole step's traced FLOPs with ``==``, and its bytes too: the test
  names, op by op, any bytes that differ (none at these shapes); the
  kernels' launches, FLOPs and bytes agree as well.
* Each kernel-shaped branch (B5, B5's backward, B6, B7, B7's backward) on
  meta and fake tensors: its outputs, the tensors it saves for backward
  and the gradients have the plain path's shapes and dtypes (the plain
  path run on the CPU with data); the counter books exactly the kernel's
  formula (``flash_attention.cost``/``cost_bwd``, ``decode_attention.
  cost``, ``ssd_scan.work``/``work_bwd``) and no aten FLOPs; no traced
  tensor ever reaches ``_build.launch``.
* ``params_total``, ``params_active`` and ``model_flops`` of ``run_cell``
  equal the reference's ``Model.param_counts`` and ``roofline.
  model_flops``; the analytic mesh kinds' per-device parameter bytes
  equal what the reference's specs give.
* ``report``'s tables equal the reference's for the same records, all but
  the lever column. A card record's roofline is its whole step's; with
  ``decompose`` it also carries the pieces, which sum to that step.
* The CLI writes records and skips; it is run on a sample of full-width
  cells (the whole table, 33 cells and 7 skips, takes minutes on a CPU).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.configs.base import cells as jcells
from repro.configs.base import skipped_cells as jskipped
from repro.launch import report as jreport
from repro.launch import roofline as jrl
from repro.models import build as jbuild
from repro.parallel import sharding as jsh
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun, report
from repro_torch.launch import roofline as rl
from repro_torch.launch.decompose import decompose_cell
from repro_torch.models.registry import build

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
FAMILIES = {"dense": "olmo-1b", "vlm": "llava-next-34b",
            "moe": "moonshot-v1-16b-a3b", "ssm": "mamba2-370m",
            "hybrid": "jamba-1.5-large-398b",
            "encdec": "seamless-m4t-medium"}
KIND_SHAPES = {"train": ShapeConfig("t", 128, 4, "train"),
               "prefill": ShapeConfig("p", 128, 2, "prefill"),
               "decode": ShapeConfig("d", 96, 2, "decode")}


def _reduced(arch):
    return get_arch(arch).reduced().replace(microbatch=2)


def _by_op(dec):
    out = {}
    for p in dec["pieces"].values():
        for k, v in p["bytes_by_op"].items():
            out[k] = out.get(k, 0) + v * p["mult"]
    return out


@pytest.mark.parametrize("kind", sorted(KIND_SHAPES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decomposition_equals_whole_step(family, kind):
    model = build(_reduced(FAMILIES[family]), "meta")
    shape = KIND_SHAPES[kind]
    fn, hold, _ = dryrun.step_call(model, shape, torch.float32,
                                   cache_dtype=torch.float32)
    whole = rl.trace(fn, hold=hold, memory=True)
    dec = decompose_cell(model, shape, dtype=torch.float32,
                         cache_dtype=torch.float32)
    tot = dec["totals"]
    assert whole["flops"] > 0 and whole["flops"] == tot["flops"]
    assert whole["kernel_flops"] == tot["kernel_flops"]
    assert whole["kernels"] == tot["kernels"]
    assert abs(tot["bytes"] - whole["bytes"]) <= 0.01 * whole["bytes"]
    parts = _by_op(dec)
    gap = {op: whole["bytes_by_op"].get(op, 0) - parts.get(op, 0)
           for op in set(parts) | set(whole["bytes_by_op"])}
    assert {op: g for op, g in gap.items() if g} == {}
    assert tot["bytes"] == whole["bytes"]
    assert whole["peak_bytes"] >= whole["held_bytes"] > 0
    if kind == "train":
        assert dec["pieces"]["optimizer"]["mult"] == 1
    roof = dec["roofline"]
    assert roof["dominant"] in ("compute", "memory")
    assert roof["t_collective"] == 0.0


# -- the kernel-shaped branches ------------------------------------------------------

def _meta_like(t, grad=False):
    return torch.empty(t.shape, dtype=t.dtype, device=META,
                       requires_grad=grad)


def _sig(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


ATTN_CASES = {
    "f32_causal": ((2, 40, 4, 16), (2, 40, 2, 16), torch.float32, True,
                   None),
    "f32_window": ((2, 48, 4, 16), (2, 48, 2, 16), torch.float32, True, 8),
    "bf16_d128": ((1, 32, 4, 128), (1, 32, 1, 128), torch.bfloat16, True,
                  None),
    "f32_cross": ((2, 24, 4, 16), (2, 40, 4, 16), torch.float32, False,
                  None),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_branch_is_kernel_shaped(case):
    qs, ks, dtype, causal, window = ATTN_CASES[case]
    g = torch.Generator().manual_seed(0)
    q = torch.randn(qs, generator=g).to(dtype).requires_grad_()
    k = torch.randn(ks, generator=g).to(dtype).requires_grad_()
    v = torch.randn(ks, generator=g).to(dtype).requires_grad_()
    out = ops.attention(q, k, v, causal=causal, window=window)
    saved = _sig(out.grad_fn.saved_tensors)
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    want = (_sig([out]), saved, _sig(grads))

    mq, mk, mv = (_meta_like(t, True) for t in (q, k, v))
    box = {}

    def run():
        o = ops.attention(mq, mk, mv, causal=causal, window=window)
        box["saved"] = o.grad_fn.saved_tensors
        box["grads"] = torch.autograd.grad(o, (mq, mk, mv),
                                           torch.empty_like(o))
        box["out"] = o
    rec = rl.trace(run)
    assert (_sig([box["out"]]), _sig(box["saved"]), _sig(box["grads"])) \
        == want
    lse = box["saved"][4]
    assert rec["aten_flops"] == 0
    assert rec["kernels"] == {
        "flash_attention": dict(zip(("flops", "bytes"), fa.cost(
            mq, mk, mv, causal, window, True)), launches=1),
        "flash_attention_bwd": dict(zip(("flops", "bytes"), fa.cost_bwd(
            mq, mk, lse, causal, window)), launches=1)}
    assert rec["kernel_flops"] == fa.work(qs, ks, causal, window) * \
        qs[-1] * (4 + 10)


def test_decode_attention_branch_is_kernel_shaped():
    g = torch.Generator().manual_seed(1)
    B, S, Hq, Hkv, D = 3, 64, 4, 2, 16
    q = torch.randn((B, Hq, D), generator=g)
    k = torch.randn((B, S, Hkv, D), generator=g).to(torch.bfloat16)
    v = torch.randn((B, S, Hkv, D), generator=g).to(torch.bfloat16)
    kv_len = torch.full((B,), S, dtype=torch.int32)
    want = ops.decode_attention(q, k, v, kv_len)
    box = {}
    rec = rl.trace(lambda: box.setdefault("o", ops.decode_attention(
        *(_meta_like(t) for t in (q, k, v, kv_len)))))
    assert _sig([box["o"]]) == _sig([want])
    assert rec["aten_flops"] == 0
    flops, nbytes = da.cost(q, k, B * S)
    assert flops == da.work(kv_len, S, Hq) * 4 * D
    assert rec["kernels"] == {"decode_attention": {
        "launches": 1, "flops": flops, "bytes": nbytes}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_branch_is_kernel_shaped(dtype):
    g = torch.Generator().manual_seed(2)
    B, S, H, P, N = 2, 256, 3, 8, 16
    x = torch.randn((B, S, H, P), generator=g).to(dtype).requires_grad_()
    a = torch.rand((B, S, H), generator=g).clamp(0.5, 1).requires_grad_()
    b = torch.randn((B, S, H, N), generator=g).to(dtype).requires_grad_()
    c0 = torch.randn((B, S, N), generator=g).to(dtype).requires_grad_()
    c = c0[:, :, None].expand(B, S, H, N)
    y, h = ops.ssd(x, a, b, c)
    saved = _sig(y.grad_fn.saved_tensors)
    grads = torch.autograd.grad((y, h), (x, a, b, c0),
                                (torch.ones_like(y), torch.ones_like(h)))
    want = (_sig([y, h]), saved, _sig(grads))

    mx, ma, mb, mc0 = (_meta_like(t, True) for t in (x, a, b, c0))
    mc = mc0[:, :, None].expand(B, S, H, N)
    box = {}

    def run():
        yy, hh = ops.ssd(mx, ma, mb, mc)
        box["out"], box["saved"] = (yy, hh), yy.grad_fn.saved_tensors
        box["grads"] = torch.autograd.grad(
            (yy, hh), (mx, ma, mb, mc0),
            (torch.empty_like(yy), torch.empty_like(hh)))
    rec = rl.trace(run)
    assert (_sig(box["out"]), _sig(box["saved"]), _sig(box["grads"])) == want
    f, nb = ss.work(mx, mb, mc)
    fb, nbb = ss.work_bwd(mx, mb, mc, True)
    assert rec["kernels"] == {
        "ssd_scan": {"launches": 1, "flops": f, "bytes": nb},
        "ssd_scan_bwd": {"launches": 1, "flops": fb, "bytes": nbb}}
    # outside the kernels only autograd's sum of dc over the broadcast H
    assert rec["aten_flops"] == 0


def test_fake_cuda_tensors_take_the_kernel_branch():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty((2, 32, 4, 16), device="cuda")
        k = torch.empty((2, 32, 2, 16), device="cuda")
        x = torch.empty((1, 128, 2, 8), device="cuda")
        a = torch.empty((1, 128, 2), device="cuda")
        b = torch.empty((1, 128, 2, 16), device="cuda")
        rec = rl.trace(lambda: (ops.attention(q, k, k),
                                ops.ssd(x, a, b, b)))
        assert isinstance(ops.attention(q, k, k),
                          torch._subclasses.fake_tensor.FakeTensor)
    assert set(rec["kernels"]) == {"flash_attention", "ssd_scan"}
    assert rec["aten_flops"] == 0


def test_counter_replays_only_meta_outputs():
    """The counter memoizes functional ops on meta tensors; a factory op
    on another device (no tensor argument) runs every time."""
    x = torch.ones(8)
    box = []
    rec = rl.trace(lambda: box.extend(torch.arange(8) + x for _ in range(3)))
    assert [t.device.type for t in box] == ["cpu"] * 3
    assert all(torch.equal(t, torch.arange(8) + 1.0) for t in box)
    m = torch.empty(8, device=META)
    rl.trace(lambda: box.extend(torch.arange(8, device=META) + m
                                for _ in range(3)))
    assert [t.device.type for t in box[3:]] == ["meta"] * 3
    assert rec["bytes"] > 0


def test_no_traced_tensor_reaches_launch(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"{name} launched on traced tensors")
    monkeypatch.setattr(_build, "launch", refuse)
    for arch in ("olmo-1b", "mamba2-370m", "jamba-1.5-large-398b"):
        model = build(_reduced(arch), "meta")
        for shape in KIND_SHAPES.values():
            fn, hold, _ = dryrun.step_call(model, shape)
            rec = rl.trace(fn, hold=hold)
            # a mamba layer decodes by its recurrence, no kernel
            assert bool(rec["kernels"]) != (
                arch == "mamba2-370m" and shape.kind == "decode")


# -- records against the reference ----------------------------------------------------

@pytest.fixture
def reduced_archs(monkeypatch):
    """``run_cell`` resolves each arch to its reduced config."""
    monkeypatch.setattr(dryrun, "get_arch", lambda a: get_arch(a).reduced())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_counts_and_model_flops_equal_reference(family,
                                                      reduced_archs):
    arch = FAMILIES[family]
    jcfg = jget_arch(arch).reduced()
    total, active = jbuild(jcfg).param_counts()
    for shape in ("train_4k", "decode_32k"):
        rec = dryrun.run_cell(arch, shape, "single", verbose=False)
        assert (rec["params_total"], rec["params_active"]) == (total, active)
        s = SHAPES[shape]
        tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
        assert rec["tokens_per_step"] == tokens
        assert rec["model_flops"] == jrl.model_flops(total, active, s.kind,
                                                     tokens)
        # every family's steps are traced partitioned on the fake (16, 16)
        # mesh, the reduced configs' decode caches under dp_heavy_rules
        # (kv_seq over model) through decode over a sequence-sharded cache
        assert "analytic" not in rec and rec["roofline"]["chips"] == 256


@pytest.mark.parametrize("mk", ["single", "multi"])
@pytest.mark.parametrize("arch", ["olmo-1b", "moonshot-v1-16b-a3b"])
def test_argument_bytes_follow_the_reference_specs(arch, mk, reduced_archs):
    import jax
    jcfg = jget_arch(arch).reduced()
    rec = dryrun.run_cell(arch, "train_4k", mk, verbose=False)
    mesh = dryrun.mesh_for(mk)
    rules = jsh.rules_for(jcfg, mesh)
    shapes, axes = jbuild(jcfg).param_struct()
    leaves = jax.tree.leaves(shapes)
    ax = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))
    want = 0
    for s, a in zip(leaves, ax):
        split = 1
        for e in jsh.spec_for(a, s.shape, rules, mesh):
            for n in ((e,) if isinstance(e, str) else e or ()):
                split *= mesh.shape[n]
        want += int(np.prod(s.shape)) * 2 // split
    assert rec["memory"]["arguments"]["params"] == want
    assert rec["accum"] >= 1


def _card_records():
    recs = {}
    for arch, shape in (("olmo-1b", "train_4k"), ("mamba2-370m",
                                                  "decode_32k"),
                        ("seamless-m4t-medium", "prefill_32k"),
                        ("jamba-1.5-large-398b", "long_500k")):
        r = dryrun.run_cell(arch, shape, device="cpu", verbose=False)
        recs[(arch, shape, "card")] = json.loads(json.dumps(r))
    recs[("olmo-1b", "long_500k", "skip")] = {
        "arch": "olmo-1b", "shape": "long_500k", "status": "skipped",
        "reason": jskipped("olmo-1b")[0][2]}
    recs[("qwen2.5-32b", "train_4k", "card")] = {
        "arch": "qwen2.5-32b", "shape": "train_4k", "mesh": "card",
        "status": "fail", "error": "x"}
    return recs


def test_report_tables_equal_reference(reduced_archs):
    recs = _card_records()
    assert report.dryrun_table(recs, "card") == \
        jreport.dryrun_table(recs, "card")
    got = report.roofline_table(recs, "card").splitlines()
    want = jreport.roofline_table(recs, "card").splitlines()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.rsplit("|", 2)[0] == w.rsplit("|", 2)[0]
    assert "TPU" not in "\n".join(got) and "Pallas" not in "\n".join(got)
    r = recs[("olmo-1b", "train_4k", "card")]
    assert r["memory"]["fits"] == (r["memory"]["peak_bytes"]
                                   <= r["device"]["mem_bytes"])
    assert r["step"]["flops"] == r["roofline"]["flops_per_device"]


@pytest.mark.parametrize("family", ["dense", "encdec"])
def test_run_cell_decomposes_on_request(family, reduced_archs):
    """A card record carries the roofline of its whole step; with
    ``decompose`` also the pieces, which sum to that step."""
    arch = FAMILIES[family]
    rec = dryrun.run_cell(arch, "train_4k", device="cpu", verbose=False)
    assert "pieces" not in rec
    assert rec["roofline"]["flops_per_device"] == rec["step"]["flops"]
    assert rec["roofline"]["bytes_per_device"] == rec["step"]["bytes"]
    dec = dryrun.run_cell(arch, "train_4k", device="cpu", verbose=False,
                          decompose=True)
    assert dec["step"] == rec["step"] and dec["roofline"] == rec["roofline"]
    for key in ("flops", "bytes"):
        assert sum(p[key] * p["mult"] for p in dec["pieces"].values()) == \
            rec["step"][key]


def test_card_kind_reads_the_card_or_refuses():
    """Without ``device="cpu"`` the card kind takes the card's own spec,
    and refuses a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_cell("mamba2-370m", "long_500k", verbose=False)
    rec = dryrun.run_cell("mamba2-370m", "long_500k", "single",
                          verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 256


def test_cell_list_equals_reference():
    run, skip = dryrun.all_cells()
    assert len(run) == 33 and len(skip) == 7
    assert run == [c for a in JARCHS for c in jcells(a)]
    assert skip == [s for a in JARCHS for s in jskipped(a)]


def test_cli_writes_sampled_full_width_cells(tmp_path):
    """Five full-width cells and one skip through the CLI in one
    subprocess (under 60 s; the whole table is the same loop)."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "mamba2-370m,olmo-1b", "--shape",
         "decode_32k,long_500k,prefill_32k", "--device", "cpu",
         "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    took = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr[-3000:]
    names = sorted(os.listdir(tmp_path))
    assert names == sorted([
        "mamba2-370m__decode_32k__card.json",
        "mamba2-370m__long_500k__card.json",
        "mamba2-370m__prefill_32k__card.json",
        "olmo-1b__decode_32k__card.json", "olmo-1b__prefill_32k__card.json",
        "olmo-1b__long_500k__skip.json"])
    recs = report.load(str(tmp_path))
    for (a, s, m), r in recs.items():
        if m == "skip":
            assert r["status"] == "skipped"
            continue
        assert r["status"] == "ok" and r["device"]["mem_bytes"] == 80 * 10**9
        assert r["step"]["flops"] == r["roofline"]["flops_per_device"]
        assert r["memory"]["peak_bytes"] >= r["memory"]["argument_size_bytes"]
    assert recs[("olmo-1b", "decode_32k", "card")]["step"]["kernels"][
        "decode_attention"]["launches"] == 16
    assert took < 60, took
