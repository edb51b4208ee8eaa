"""attention_roofline (%): the least time of the window's B5 launches,
forward and backward (``counts.kernels.attention_*`` at the cell's
microbatch, over the program's launch counts), over their kernels'
device time, matched by kernel name."""

LAUNCHES = ("flash_attention", "flash_attention_bwd")
PATTERNS = (r"^(?!.*pytorch_flash).*\bflash_(fwd|bwd|combine)",)


def read(ctx):
    return ctx.roofline(LAUNCHES, PATTERNS)
