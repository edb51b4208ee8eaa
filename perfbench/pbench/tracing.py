"""Reading a ``torch.profiler`` trace of the window.

The harness marks the window with the span ``perfbench.window`` and each
step with ``perfbench.step``; the window's bounds come from that span, on
the trace's own clock. Device operations (kernels, copies, fills) are
clipped to the window. ``Trace`` gives what the per-layer readers and the
result's ``device`` and ``breakdown`` need: the union of device busy
intervals, device seconds by operation name, and the longest idle gaps,
each named by the innermost host event running when it opened.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Tuple

import numpy as np

WINDOW = "perfbench.window"
STEP = "perfbench.step"
NAME_CHARS = 160       # operation names are cut to this many characters
SPANS = (WINDOW, STEP)


class Trace:
    def __init__(self, device_ops: List[Tuple[str, float, float]],
                 host_ops: List[Tuple[str, float, float]]):
        """Events as (name, start_s, end_s) on one clock."""
        wins = [(s, e) for n, s, e in host_ops if n == WINDOW]
        if len(wins) != 1:
            raise RuntimeError(f"the trace holds {len(wins)} window spans")
        self.t0, self.t1 = wins[0]
        self.steps = sum(1 for n, s, e in host_ops
                         if n == STEP and s >= self.t0 and e <= self.t1)
        self.ops = [(n, max(s, self.t0), min(e, self.t1))
                    for n, s, e in device_ops if e > self.t0 and s < self.t1]
        self.host = [(n, s, e) for n, s, e in host_ops
                     if n != WINDOW and e > self.t0 and s < self.t1]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def _sweep(self):
        """(busy seconds, [(gap start, gap length)]) of the union of the
        device intervals."""
        if not self.ops:
            return 0.0, [(self.t0, self.window_s)]
        iv = np.array([(s, e) for _, s, e in self.ops])
        iv = iv[np.argsort(iv[:, 0])]
        ends = np.maximum.accumulate(iv[:, 1])
        starts = iv[:, 0]
        gap_at = np.concatenate([[self.t0], ends[:-1]])
        gap_len = starts - gap_at
        gaps = [(float(a), float(g)) for a, g in zip(gap_at, gap_len)
                if g > 0]
        if self.t1 > ends[-1]:
            gaps.append((float(ends[-1]), float(self.t1 - ends[-1])))
        idle = sum(g for _, g in gaps)
        return self.window_s - idle, gaps

    def busy_s(self) -> float:
        return self._sweep()[0]

    def device_seconds(self, patterns: Iterable[str]) -> float:
        """Seconds of device operations whose name matches a pattern."""
        rx = re.compile("|".join(f"(?:{p})" for p in patterns))
        return sum(e - s for n, s, e in self.ops if rx.search(n))

    def top_ops(self, k: int = 10) -> List[List]:
        by = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:NAME_CHARS], v] for n, v in top]

    def top_gaps(self, k: int = 10) -> List[List]:
        """The k longest idle gaps, each named by the innermost host event
        open at its start."""
        gaps = sorted(self._sweep()[1], key=lambda g: -g[1])[:k]
        out = []
        for at, length in gaps:
            open_ = [(s, n) for n, s, e in self.host if s <= at < e]
            name = max(open_)[1] if open_ else "(no host event)"
            out.append([name[:NAME_CHARS], length])
        return out


def from_profiler(prof) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device_ops, host_ops = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.device_type() != DeviceType.CUDA:
            host_ops.append((e.name(), s, s + d))
        elif e.name() not in SPANS:
            # kernels, copies and fills; a span's device mirror covers a
            # whole step and is no operation
            device_ops.append((e.name(), s, s + d))
    return Trace(device_ops, host_ops)
