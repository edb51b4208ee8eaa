"""recompute_ms_per_step (ms): card time a step in the program's
``train.recompute`` spans (each remat body that autograd replays inside
the backward), averaged over the window's steps; matched and read as
``forward_ms_per_step`` reads its phase."""
from pathlib import Path

from pbench import spec

PHASE = "train.recompute"


def read(ctx):
    return spec.metric_reader("forward_ms_per_step",
                              root=Path(__file__).resolve().parents[2]
                              ).phase_ms(ctx, PHASE)
