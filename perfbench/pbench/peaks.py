"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). The run records
the card's own power limit beside every share.

F32 is the rate for float32 operands: TF32 on the tensor cores, the
fastest way the card multiplies f32 operands. An f32-accurate route
(3xTF32, or the CUDA cores' 67 TFLOP/s) is slower, so a share against
this rate cannot pass 100% whatever route a later change takes.
"""
F32 = 495e12          # FLOP/s, f32 operands (TF32 tensor cores)
BF16 = 989e12         # FLOP/s, bf16 and fp16 operands
HBM = 3.35e12         # bytes/s


def bound_s(flops: float, nbytes: float, peak: float = F32) -> float:
    """The least time the card can take: max(flops / peak, bytes / HBM)."""
    return max(flops / peak, nbytes / HBM)
