"""The readers of the program's own spans (``forward_ms_per_step``,
``backward_ms_per_step``, ``recompute_ms_per_step``, ``adamw_ms_per_step``,
``launches_per_step`` and their ``.ssm`` twins): on a synthetic trace and
ring each returns the value worked out by hand, and each returns None
where there is nothing to read: a trace without the program's spans, a
step without its record, a record without card times. On the card, a
cell's traced window holds what the readers assume."""
import pytest

from pbench import harness, spec, tracing
from repro_torch.obs import steps as spans
from test_perfbench_run import _trace

PHASES = {"forward_ms_per_step": (100.0, 110.0),
          "backward_ms_per_step": (250.0, 270.0),
          "recompute_ms_per_step": (80.0, 90.0),
          "adamw_ms_per_step": (40.0, 44.0)}
PHASE_OF = {"forward_ms_per_step": spans.FORWARD,
            "backward_ms_per_step": spans.BACKWARD,
            "recompute_ms_per_step": spans.RECOMPUTE,
            "adamw_ms_per_step": spans.ADAMW}
NEW = tuple(PHASES) + ("launches_per_step",)


class _Record:
    def __init__(self, begin_s, ms):
        self.begin_ns = round(begin_s * 1e9)
        self.ms = ms

    def card_ms(self):
        return self.ms


def _program_trace():
    """Two steps in a window: the program's ``train.step`` spans inside
    the harness's, launch calls inside and outside them."""
    dev = [("sm80_xmma_gemm_f32f32_nn", 1.2, 2.0),
           ("void at::native::vectorized_elementwise_kernel<add>", 5.5, 6.0)]
    host = [(tracing.WINDOW, 1.0, 9.0), (tracing.STEP, 1.0, 5.0),
            (spans.STEP, 1.1, 4.9), (tracing.STEP, 5.0, 9.0),
            (spans.STEP, 5.1, 8.9),
            ("cudaLaunchKernel", 1.2, 1.21), ("cudaLaunchKernel", 2.0, 2.01),
            ("cuLaunchKernel", 3.0, 3.01), ("cudaLaunchKernel", 4.95, 4.96),
            ("cudaLaunchKernelExC", 5.5, 5.51),
            ("cudaMemcpyAsync", 5.6, 5.7), ("aten::mm", 1.15, 1.3)]
    return tracing.Trace(dev, host)


def _ring(offset_s=0.0004, card=True):
    ms = [{PHASE_OF[q]: v[i] for q, v in PHASES.items()} for i in range(2)]
    return [_Record(0.3, ms[0] if card else None),      # a step before
            _Record(1.1 + offset_s, ms[0] if card else None),
            _Record(5.1 - offset_s, ms[1] if card else None)]


def _read(cell, trace, ring, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: list(ring))
    return harness.per_layer(cell, {"trace": trace, "launches": {}})


@pytest.mark.parametrize("name,suffix", [("olmo-1b.train.ctx2k", ""),
                                         ("mamba2-370m.train.seq16k",
                                          ".ssm")])
def test_readers_on_a_synthetic_trace_and_ring(tiny_cell, monkeypatch, name,
                                               suffix):
    cell, _ = tiny_cell(name)
    out = _read(cell, _program_trace(), _ring(), monkeypatch)
    for q, (a, b) in PHASES.items():
        assert out[q + suffix] == {"value": pytest.approx((a + b) / 2),
                                   "unit": "ms"}
    # 3 launches in the first step, 1 in the second; the one between the
    # program's span and the harness's end is not the step's
    assert out["launches_per_step" + suffix] == {"value": 2.0,
                                                 "unit": "launches"}


def test_readers_read_nothing_without_the_programs_spans(tiny_cell,
                                                         monkeypatch):
    cell, _ = tiny_cell("olmo-1b.train.ctx2k")
    out = _read(cell, _trace(), _ring(), monkeypatch)
    assert "device_idle_share" in out
    assert not set(NEW) & set(out)


@pytest.mark.parametrize("ring", [_ring(offset_s=0.0011), _ring(card=False),
                                  _ring()[:2], []],
                         ids=["offset", "off_the_card", "a_step_missing",
                              "empty"])
def test_readers_read_nothing_without_a_record_of_every_step(
        tiny_cell, monkeypatch, ring):
    cell, _ = tiny_cell("mamba2-370m.train.seq16k")
    out = _read(cell, _program_trace(), ring, monkeypatch)
    assert "device_idle_share.ssm" in out
    assert not {q + ".ssm" for q in NEW} & set(out)


@pytest.mark.parametrize("name", ["olmo-1b.train.ctx2k",
                                  "mamba2-370m.train.seq16k"])
def test_program_spans_on_the_card(cuda, name):
    """The cell at its size, a short traced window: no device event is a
    program span; every step matched within 1 ms; forward, backward and
    AdamW tile 90-100% of the window's ms a step; the recompute lies
    inside the backward; launches a step within 2% of the kernels a
    step."""
    cell = spec.cell(name)
    prog = harness.Program(cell, 2**31 + 35, cuda)
    prog.checked_steps()
    spans.clear()
    win = prog.window(6.0, trace=True)
    prog.free()
    tr = win["trace"]
    names = {spans.STEP, spans.MICROBATCH, spans.GC} | set(spans.CARD_PHASES)
    assert not {n for n, _, _ in tr.ops} & names
    ctx = harness.LayerContext(cell, win)
    got = {q: spec.metric_reader(q).read(ctx) for q in NEW}
    assert None not in got.values(), got
    window_ms = 1e3 * tr.window_s / tr.steps
    tiled = sum(got[q] for q in ("forward_ms_per_step",
                                 "backward_ms_per_step",
                                 "adamw_ms_per_step"))
    assert 0.9 * window_ms <= tiled <= window_ms, (tiled, window_ms)
    assert 0 < got["recompute_ms_per_step"] < got["backward_ms_per_step"]
    kernels = sum(1 for n, _, _ in tr.ops
                  if not n.startswith(("Memcpy", "Memset")))
    assert got["launches_per_step"] == pytest.approx(kernels / tr.steps,
                                                     rel=0.02)
    begins = [r.begin_ns * 1e-9 for r in spans.records()]
    offsets = [min(abs(b - s) for b in begins) for s, _ in
               spec.metric_reader("forward_ms_per_step").window_steps(ctx)]
    assert len(offsets) == tr.steps and max(offsets) < 1e-3
