"""launches_per_step (launches): the host's kernel launch calls a step, in
the trace: host events named as a CUDA runtime or driver launch that
start inside one of the window's ``train.step`` spans, over those spans.
None where ``forward_ms_per_step`` matches no step (a program without the
spans, or a step off the card)."""
import bisect
from pathlib import Path

from pbench import spec

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


def read(ctx):
    m = spec.metric_reader("forward_ms_per_step",
                           root=Path(__file__).resolve().parents[2]
                           ).matched(ctx)
    if m is None:
        return None
    starts = sorted(s for n, s, _ in ctx.trace.host if n in LAUNCHES)
    n = sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
            for (s, e), _ in m)
    return n / len(m)
