"""Spans and card times inside the training step, recorded while a
``torch.profiler`` records.

``launch/steps.py``'s training step opens ``train.step`` around its whole
body, ``train.microbatch`` around each microbatch, ``train.forward``
around the loss, ``train.backward`` around the gradients and their
accumulation, and ``train.adamw`` around ``finish_grads`` and the AdamW
update; ``models/remat.py`` opens ``train.recompute`` around each body
that autograd replays in the backward (on autograd's thread). A Python
garbage collection that runs inside a step is the span ``python.gc``.

Each span is a FUNCTION-scope record (``_RecordFunctionFast``), so it
lands in the profiler's trace as a host event on the trace's own clock.
The profiler mirrors none of them onto the device: a
``record_function`` span is a user annotation, which the profiler also
draws on the device as an interval from its first kernel to its last,
and such an interval would read as device work. On the card the phases
``CARD_PHASES`` also record a CUDA event on the current stream at entry
and at exit; a phase's card time is the time between the two on the
in-order stream, which the phase occupies whether the device is busy or
waits for the host.

Each step's ``StepRecord`` (host begin and end on the trace's clock, the
card phases' events, resolved to ms only when read, and the step's
collections) goes into a ring of the last ``RING`` steps; ``records()``
reads it. Nothing is exported: the trace holds the spans.

When no profiler records, a span costs one check: no event is created,
nothing is appended, and no ``gc`` callback is registered. One training
step at a time records.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

STEP = "train.step"
MICROBATCH = "train.microbatch"
FORWARD = "train.forward"
BACKWARD = "train.backward"
RECOMPUTE = "train.recompute"
ADAMW = "train.adamw"
GC = "python.gc"
CARD_PHASES = (FORWARD, BACKWARD, RECOMPUTE, ADAMW)
RING = 256

_OFF = contextlib.nullcontext()


class StepRecord:
    """One recorded step: ``begin_ns`` and ``end_ns`` on the trace's clock
    (Unix ns), ``events`` (phase, start, end CUDA events) on the card,
    ``gcs`` (generation, begin_ns, end_ns, collected) per collection."""

    __slots__ = ("card", "begin_ns", "end_ns", "events", "gcs")

    def __init__(self, card: bool):
        self.card = card
        self.begin_ns = self.end_ns = 0
        self.events: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self.gcs: List[Tuple[int, int, int, int]] = []

    def card_ms(self) -> Optional[Dict[str, float]]:
        """Each card phase's ms, summed over the step; None for a step that
        ran off the card."""
        if not self.card:
            return None
        out = dict.fromkeys(CARD_PHASES, 0.0)
        for name, start, end in self.events:
            end.synchronize()
            out[name] += start.elapsed_time(end)
        return out


_RING: Deque[StepRecord] = collections.deque(maxlen=RING)
_OPEN: List[Optional[StepRecord]] = [None]
_GC_OPEN: List[Tuple[_RecordFunctionFast, int]] = []


def recording() -> bool:
    """Whether a profiler records this thread's operations."""
    return torch._C._autograd._profiler_enabled()


def records() -> List[StepRecord]:
    """The ring's records, oldest first."""
    return list(_RING)


def clear() -> None:
    _RING.clear()


def _card_event() -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _on_gc(phase: str, info: Dict) -> None:
    if phase == "start":
        rf = _RecordFunctionFast(GC)
        rf.__enter__()
        _GC_OPEN.append((rf, time.time_ns()))
    elif _GC_OPEN:
        rf, begin = _GC_OPEN.pop()
        end = time.time_ns()
        rf.__exit__(None, None, None)
        rec = _OPEN[0]
        if rec is not None:
            rec.gcs.append((info["generation"], begin, end,
                            info["collected"]))


class _Step:
    def __init__(self, device: torch.device):
        self.rec = StepRecord(device.type == "cuda")
        self.rf = _RecordFunctionFast(STEP)

    def __enter__(self):
        self.rf.__enter__()
        self.rec.begin_ns = time.time_ns()
        _OPEN[0] = self.rec
        gc.callbacks.append(_on_gc)
        return self.rec

    def __exit__(self, *exc):
        gc.callbacks.remove(_on_gc)
        _OPEN[0] = None
        self.rec.end_ns = time.time_ns()
        self.rf.__exit__(*exc)
        _RING.append(self.rec)
        return False


class _Span:
    def __init__(self, name: str):
        self.name = name
        self.rf = _RecordFunctionFast(name)
        self.rec = self.start = None

    def __enter__(self):
        self.rf.__enter__()
        rec = _OPEN[0]
        if rec is not None and rec.card and self.name in CARD_PHASES:
            self.rec, self.start = rec, _card_event()

    def __exit__(self, *exc):
        if self.start is not None:
            self.rec.events.append((self.name, self.start, _card_event()))
        self.rf.__exit__(*exc)
        return False


def step(device: torch.device):
    """The span of one training step on ``device``, whose record goes
    into the ring; a no-op context when no profiler records."""
    return _Step(device) if recording() else _OFF


def span(name: str):
    """The span ``name`` inside the open step (card events for the
    ``CARD_PHASES``); a no-op context when no profiler records."""
    return _Span(name) if recording() else _OFF
