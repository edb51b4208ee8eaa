"""The training step's spans (``repro_torch.obs.steps``) under a CPU
``torch.profiler``, on reduced olmo-1b (dense family) and mamba2-370m (ssm
family) ``make_train_step`` steps.

* The spans nest ``train.step`` > ``train.microbatch`` > ``train.forward``
  / ``train.backward`` > ``train.recompute``: ``accum`` microbatches,
  forwards and backwards a step, one recompute per remat body and
  microbatch, one AdamW span a step; none is a user annotation, which the
  profiler would mirror onto the device.
* The ring holds one record per profiled step, with host stamps within
  1 ms of the trace's ``train.step`` events, and no card times off the
  card; a collection inside a step is a ``python.gc`` span and is
  recorded with its generation.
* With no profiler a step creates no record and leaves ``gc.callbacks``
  unchanged.
"""
import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build, lm
from repro_torch.obs import steps as spans

ARCHS = ("olmo-1b", "mamba2-370m")
SHAPE = ShapeConfig("t", 32, 4, "train")        # 2 microbatches of 2 rows
PROGRAM = (spans.STEP, spans.MICROBATCH, spans.FORWARD, spans.BACKWARD,
           spans.RECOMPUTE, spans.ADAMW, spans.GC)


def _step(arch):
    cfg = get_arch(arch).reduced().replace(microbatch=2)
    model = build(cfg, torch.device("cpu"))
    params = model.init(torch.Generator().manual_seed(0),
                        torch.float32).requires_grad_(True)
    step_fn, opt_init = make_train_step(model, SHAPE)
    tokens = torch.randint(0, cfg.vocab, (SHAPE.global_batch, SHAPE.seq_len),
                           generator=torch.Generator().manual_seed(1))
    state = [params, opt_init(params), 1]

    def run():
        p, o, loss, _ = step_fn(state[0], state[1], {"tokens": tokens},
                                state[2])
        state[:] = [p, o, state[2] + 1]
        return float(loss)
    return cfg, model, step_fn.accum, run


def _events(prof):
    """{name: [(start_ns, end_ns, is_user_annotation)]} of the program's
    spans."""
    out = {n: [] for n in PROGRAM}
    for e in prof.profiler.kineto_results.events():
        if e.name() in out:
            out[e.name()].append((e.start_ns(), e.end_ns(),
                                  e.is_user_annotation()))
    return out


def _inside(inner, outer):
    return [next(i for i, (s, e, _) in enumerate(outer)
                 if s <= a and b <= e) for a, b, _ in inner]


@pytest.fixture(autouse=True)
def _empty_ring():
    spans.clear()
    yield
    spans.clear()


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_nest_and_count_under_the_profiler(arch):
    cfg, _, accum, run = _step(arch)
    run()
    n_steps = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n_steps):
            run()
    ev = _events(prof)
    bodies = sum(seg.count for seg in lm.build_schedule(cfg))
    assert accum == 2 and bodies >= 2
    assert len(ev[spans.STEP]) == n_steps
    assert len(ev[spans.ADAMW]) == n_steps
    for name in (spans.MICROBATCH, spans.FORWARD, spans.BACKWARD):
        assert len(ev[name]) == n_steps * accum, name
    assert len(ev[spans.RECOMPUTE]) == n_steps * accum * bodies
    assert not any(u for n in PROGRAM for *_, u in ev[n])
    mb_step = _inside(ev[spans.MICROBATCH], ev[spans.STEP])
    assert sorted(mb_step) == [i for i in range(n_steps) for _ in range(accum)]
    for name in (spans.FORWARD, spans.BACKWARD):
        assert sorted(_inside(ev[name], ev[spans.MICROBATCH])) == \
            list(range(n_steps * accum))
    rec_bwd = _inside(ev[spans.RECOMPUTE], ev[spans.BACKWARD])
    assert sorted(rec_bwd) == [i for i in range(n_steps * accum)
                               for _ in range(bodies)]
    assert _inside(ev[spans.ADAMW], ev[spans.STEP]) == list(range(n_steps))


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_holds_a_record_per_profiled_step(arch):
    _, _, _, run = _step(arch)
    run()
    assert spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        run()
    run()
    recs = spans.records()
    steps = sorted(_events(prof)[spans.STEP])
    assert len(recs) == len(steps) == 2
    for r, (s, e, _) in zip(recs, steps):
        assert abs(r.begin_ns - s) < 1e6 and abs(r.end_ns - e) < 1e6
        assert r.card_ms() is None and r.events == []


def test_a_collection_inside_a_step_is_a_gc_span():
    _, model, _, run = _step("olmo-1b")
    whole = model.loss

    def collecting(*a, **kw):
        gc.collect(2)
        return whole(*a, **kw)
    model.loss = collecting
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    ev = _events(prof)
    fwd = ev[spans.FORWARD]
    full = [g for g in spans.records()[0].gcs if g[0] == 2]
    assert len(full) == 2                       # one per microbatch's loss
    assert all(b <= e for _, b, e, _ in full)
    gcs = [g for g in ev[spans.GC]
           if any(s <= g[0] and g[1] <= e for s, e, _ in fwd)]
    assert len(gcs) >= 2


def test_no_profiler_no_record_and_no_gc_callback():
    _, _, _, run = _step("mamba2-370m")
    callbacks = list(gc.callbacks)
    run()
    run()
    assert spans.records() == []
    assert gc.callbacks == callbacks
    assert not spans.recording()
    assert spans.step(torch.device("cpu")) is spans.span(spans.FORWARD)
