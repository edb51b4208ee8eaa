"""adamw_ms_per_step (ms): card time a step in the program's
``train.adamw`` span (``finish_grads``: the gradient sums divided and
the mean loss; the global norm, clipping and AdamW's update), averaged
over the window's steps; matched and read as ``forward_ms_per_step``
reads its phase."""
from pathlib import Path

from pbench import spec

PHASE = "train.adamw"


def read(ctx):
    return spec.metric_reader("forward_ms_per_step",
                              root=Path(__file__).resolve().parents[2]
                              ).phase_ms(ctx, PHASE)
