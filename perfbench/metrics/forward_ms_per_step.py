"""forward_ms_per_step (ms): card time a step in the program's
``train.forward`` spans (each microbatch's loss), summed over the step's
microbatches, averaged over the window's steps.

The program records, while a profiler records, a ``train.step`` host span
on the trace's clock per step and, on the card, a CUDA event at the entry
and exit of each phase (``repro_torch.obs.steps``). A window's steps are
its ``train.step`` spans; each is matched to the program's record whose
host begin lies within ``MATCH_S`` of the span's. This file holds the
matching, which the other phase readers and ``launches_per_step`` share.
None where the trace holds no ``train.step`` (a program without the
spans), where a step has no record, or where a record has no card times
(a step off the card)."""
from typing import List, Optional, Tuple

PHASE = "train.forward"
STEP = "train.step"
MATCH_S = 1e-3


def window_steps(ctx) -> List[Tuple[float, float]]:
    """(start, end) of each ``train.step`` span inside the window."""
    tr = ctx.trace
    return sorted((s, e) for n, s, e in tr.host
                  if n == STEP and s >= tr.t0 and e <= tr.t1)


def matched(ctx) -> Optional[List[Tuple[Tuple[float, float], dict]]]:
    """[((start, end), the record's card ms by phase)] for each window
    step, or None where any step has no record or no card times."""
    spans = window_steps(ctx)
    if not spans:
        return None
    try:
        from repro_torch.obs import steps
    except ImportError:
        return None
    begins = [(r.begin_ns * 1e-9, r) for r in steps.records()]
    out = []
    for s, e in spans:
        near = min(begins, key=lambda b: abs(b[0] - s), default=None)
        if near is None or abs(near[0] - s) > MATCH_S:
            return None
        ms = near[1].card_ms()
        if ms is None:
            return None
        out.append(((s, e), ms))
    return out


def phase_ms(ctx, phase: str) -> Optional[float]:
    m = matched(ctx)
    if m is None:
        return None
    return sum(ms[phase] for _, ms in m) / len(m)


def read(ctx):
    return phase_ms(ctx, PHASE)
