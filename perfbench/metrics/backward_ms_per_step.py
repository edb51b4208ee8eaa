"""backward_ms_per_step (ms): card time a step in the program's
``train.backward`` spans (each microbatch's ``torch.autograd.grad``,
with the remat recompute inside it, and the gradients' accumulation),
averaged over the window's steps; matched and read as
``forward_ms_per_step`` reads its phase."""
from pathlib import Path

from pbench import spec

PHASE = "train.backward"


def read(ctx):
    return spec.metric_reader("forward_ms_per_step",
                              root=Path(__file__).resolve().parents[2]
                              ).phase_ms(ctx, PHASE)
