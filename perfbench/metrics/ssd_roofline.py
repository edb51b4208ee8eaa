"""ssd_roofline (%): the least time of the window's B7 launches, forward
and backward (``counts.kernels.ssd_*`` at the cell's microbatch, over the
program's launch counts), over their kernels' device time, matched by
kernel name."""

LAUNCHES = ("ssd_scan", "ssd_scan_bwd")
PATTERNS = (r"\bssd_(chunk_state|state_passing|chunk_scan|bwd_)",)


def read(ctx):
    return ctx.roofline(LAUNCHES, PATTERNS)
