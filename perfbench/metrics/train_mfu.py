"""train_mfu (%): model FLOPs of the window's steps (the family's
``counts.step_flops``) over the card's peak for f32 operands times the
window's length, from the device trace's window span."""
from pbench import peaks


def read(ctx):
    if ctx.steps <= 0 or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.step_flops() * ctx.steps / (peaks.F32
                                                   * ctx.trace.window_s)
