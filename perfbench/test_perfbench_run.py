"""A run of a cell, cut to CPU size: the program's checked steps and
window against the reference, and the comparison's verdict on sound runs,
on the control and on the faults a training cell can have."""
import math

import pytest
import torch

from pbench import check, harness, spec, tracing

CELLS = ("olmo-1b.train.ctx2k", "mamba2-370m.train.seq16k")
SEED = 2**31 + 77


def _readings(cell, arch, plant=None):
    prog = harness.Program(cell, SEED, "cpu", arch)
    if plant is not None:
        plant(prog)
    mine = prog.checked_steps()
    win = prog.window(0.2, trace=True)
    prog.free()
    return mine, win


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    cell, arch = tiny_cell(name)
    mine, win = _readings(cell, arch)
    ref = harness.reference_readings(cell, SEED, "cpu")
    nums = check.numbers(mine, ref)
    assert check.verdict(nums, cell.workload["limits"]), nums
    assert win["steps"] >= 1 and win["failed"] == 0
    assert win["trace"].steps == win["steps"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_faulted_program_is_not_correct(tiny_cell, name, fault):
    cell, arch = tiny_cell(name)
    plant = getattr(harness, f"plant_{fault}")
    mine, _ = _readings(cell, arch, plant)
    nums = check.numbers(mine, harness.reference_readings(cell, SEED, "cpu"))
    assert not check.verdict(nums, cell.workload["limits"]), nums
    if fault == "unchanged_state":
        assert nums["change_gap"] == pytest.approx(1.0)


def test_ssd_state_dropped_between_chunks_is_not_correct(tiny_cell):
    """The SSD restarted from a zero state every 8 steps, as if the state
    passed between chunks were dropped; the fault is undone by ``free``."""
    from repro_torch.kernels import ops
    cell, arch = tiny_cell("mamba2-370m.train.seq16k")
    whole = ops.ssd
    mine, _ = _readings(cell, arch,
                        lambda p: harness.plant_state_dropped(p, 8))
    assert ops.ssd is whole
    nums = check.numbers(mine, harness.reference_readings(cell, SEED, "cpu"))
    assert not check.verdict(nums, cell.workload["limits"]), nums


def test_end_to_end_metrics_are_their_quantities(tiny_cell):
    for name in CELLS:
        cell, _ = tiny_cell(name)
        win = {"steps": 3, "seconds": 2.0, "peak_bytes": 5e9}
        out = harness.end_to_end(cell, win, 7.5)
        tps = [v for k, v in out.items()
               if spec.quantity(k) == "train_tokens_per_s"]
        assert [t["value"] for t in tps] == [1.5 * cell.traffic["rows"]
                                             * cell.traffic["seq_len"]]
        assert out["train_peak_gb"]["value"] == 5.0
        assert out["setup_s"] == {"value": 7.5, "unit": "s"}


@pytest.mark.parametrize("name", CELLS)
def test_control_in_lower_precision_is_not_correct(tiny_cell, name):
    """TF32, the precision below the configuration's f32, in the program's
    place (on the CPU its operands rounded to TF32)."""
    cell, _ = tiny_cell(name)
    ref = harness.reference_readings(cell, SEED, "cpu")
    ctrl = harness.reference_readings(cell, SEED, "cpu", "tf32")
    assert not check.verdict(check.numbers(ctrl, ref), cell.workload["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card_is_not_correct(tiny_cell, cuda, name):
    cell, _ = tiny_cell(name, seq=256)
    ref = harness.reference_readings(cell, SEED, cuda)
    ctrl = harness.reference_readings(cell, SEED, cuda, "tf32")
    assert not check.verdict(check.numbers(ctrl, ref), cell.workload["limits"])


def test_a_non_finite_reading_fails_every_limit():
    r = check.Readings(losses=[1.0, math.nan, 1.0], gnorms=[1.0] * 3,
                       grad_norms={"a": 1.0, "b": 2.0},
                       grad_probes={"a": 0.5, "b": 0.1},
                       change_norms={"a": 1.0, "b": 1.0})
    ok = check.Readings(losses=[1.0] * 3, gnorms=[1.0] * 3,
                        grad_norms={"a": 1.0, "b": 2.0},
                        grad_probes={"a": 0.5, "b": 0.1},
                        change_norms={"a": 1.0, "b": 1.0})
    nums = check.numbers(r, ok)
    assert math.isnan(nums["loss_gap"])
    assert not check.verdict(nums, {"loss_gap": 1.0})
    assert check.verdict(check.numbers(ok, ok), {k: 0.0 for k in nums})


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch.models", "torch", "reprox", "jaxtyping"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["repro.core", "jax"]) == \
        ["jax", "repro"]


def _trace():
    dev = [("sm80_xmma_gemm_f32f32_nn", 1.0, 2.0),
           ("void (anonymous namespace)::flash_fwd_kernel<128>(...)", 2.0,
            2.5),
           ("void (anonymous namespace)::flash_bwd_dq_tc<128>(...)", 2.5,
            3.0),
           ("void at::native::vectorized_elementwise_kernel<add>", 3.5,
            3.75),
           ("(anonymous namespace)::ssd_chunk_scan(...)", 3.75, 4.0)]
    host = [(tracing.WINDOW, 1.0, 5.0), (tracing.STEP, 1.0, 3.2),
            (tracing.STEP, 3.2, 5.0), ("aten::item", 3.0, 3.6),
            ("cudaStreamSynchronize", 4.0, 5.0)]
    return tracing.Trace(dev, host)


def test_trace_busy_share_gaps_and_ops():
    tr = _trace()
    assert tr.window_s == 4.0 and tr.steps == 2
    assert tr.busy_s() == pytest.approx(2.5)
    assert tr.top_gaps(2) == [["cudaStreamSynchronize", 1.0],
                              ["aten::item", 0.5]]
    assert tr.top_ops(1) == [["sm80_xmma_gemm_f32f32_nn", 1.0]]


def test_layer_readers_on_a_trace(tiny_cell):
    cell, arch = tiny_cell("olmo-1b.train.ctx2k")
    win = {"trace": _trace(), "launches": {"flash_attention": 2,
                                           "flash_attention_bwd": 1}}
    out = harness.per_layer(cell, win)
    assert out["device_idle_share"]["value"] == pytest.approx(37.5)
    assert out["gemm_ms_per_step"]["value"] == pytest.approx(500.0)
    bounds = harness.LayerContext(cell, win).launch_bounds()
    want = 100 * (2 * bounds["flash_attention"]
                  + bounds["flash_attention_bwd"]) / 1.0
    assert out["attention_roofline"]["value"] == pytest.approx(want)
    assert 0 < out["train_mfu"]["value"] < 100
    mamba, _ = tiny_cell("mamba2-370m.train.seq16k")
    assert "ssd_roofline" not in out
    win["launches"] = {}
    split = harness.per_layer(mamba, win)
    assert "ssd_roofline" not in split
    assert split["device_idle_share.ssm"] == out["device_idle_share"]
