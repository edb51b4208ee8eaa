"""gemm_ms_per_step (ms): device time a step in the cuBLAS and CUTLASS
matrix-product kernels (the model body's projections, MLP and tied
logits), matched by kernel name."""

PATTERNS = (r"(?i:gemm)", r"(?i:gemv)", r"(?i:xmma)", r"(?i:cutlass)",
            r"(?i:nvjet)", r"(?i:splitkreduce)")


def read(ctx):
    if ctx.steps <= 0:
        return None
    ms = 1e3 * ctx.trace.device_seconds(PATTERNS) / ctx.steps
    return ms if ms > 0 else None
