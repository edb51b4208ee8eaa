"""device_idle_share (%): the window's time in which no kernel, copy or
fill ran on the card, over the window, from the device trace."""


def read(ctx):
    w = ctx.trace.window_s
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / w)
