"""Target hardware constants (NVIDIA H100 SXM) + paper-cluster calibration.

Kernel bounds in the port read from here. The device figures are the
published H100 SXM data-sheet peaks; where a card is present, its SM count,
memory and L2 size are read from ``torch.cuda.get_device_properties``
instead. HBM bandwidth is not among the device properties, so bounds always
use the data-sheet rate.

``resolve_device`` is the one place that turns a ``device=`` argument into
a ``torch.device``: entry points default to ``"cuda"`` and refuse to fall
back to the CPU silently.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# --- NVIDIA H100 SXM (data sheet; dense rates, 700 W power limit) ------------
HBM_BW = 3.35e12               # bytes/s
HBM_BYTES = 80 * 10**9         # device memory
L2_BYTES = 50 * 2**20          # L2 cache
NUM_SMS = 132
SMEM_PER_BLOCK_MAX = 232_448   # bytes (227 KB), dynamic shared memory only
# Peak of the CUDA cores outside the tensor cores: 67 TFLOP/s fp32. The
# port's NIC kernels do 32-bit integer ALU work (hash mixing, ARX rounds,
# DFA stepping); it is counted against this rate, which no integer pipe of
# the card exceeds, so a bound from it is a true lower bound on time.
PEAK_ALU_OPS = 67e12
# Dense tensor-core peaks: bf16 (and fp16) operands, and TF32 (f32 operands
# rounded to a 10-bit mantissa).
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_TF32_TENSOR_FLOPS = 495e12
# f32-accurate products run on the tensor cores too, as 3xTF32: each f32
# operand splits into a TF32 high part and a TF32 residual, and three
# products (hi·hi, hi·lo, lo·hi) are summed in f32. That is CUTLASS's
# arch::OpMultiplyAddFastF32, which PyTorch's memory-efficient attention
# uses for float inputs on sm_80 and later (ATen/native/transformers/cuda/
# mem_eff_attention/gemm_kernel_utils.h), and B5 and B7 use it. So the
# fastest f32-accurate route on the card is a third of the TF32 rate, 165
# TFLOP/s, not the CUDA cores' 67.
PEAK_F32_TENSOR_FLOPS = PEAK_TF32_TENSOR_FLOPS / 3

# --- Links between H100s (the partitioned steps' collective term) -----------
# NVLink 4 within an 8-GPU HGX H100 node: 900 GB/s a GPU in all, 450 GB/s
# a direction (H100 SXM data sheet). Between nodes, each GPU has its own
# ConnectX-7 NIC at 400 Gb/s, 50 GB/s a direction (DGX H100 data sheet:
# 8x single-port ConnectX-7 400 Gb/s InfiniBand/Ethernet).
GPUS_PER_NODE = 8
NVLINK_BW = 450e9              # bytes/s a direction, within a node
NODE_NET_BW = 50e9             # bytes/s a direction a GPU, between nodes


def axis_link_bw(axes) -> dict:
    """``{mesh axis: link rate}`` for a row-major mesh ``{axis: size}``
    laid over 8-GPU nodes in rank order: an axis whose groups stay inside
    one node (stride x size <= 8) runs over NVLink, any other over the
    nodes' network, its slowest link."""
    out, stride = {}, 1
    for name, size in reversed(list(axes.items())):
        out[name] = NVLINK_BW if stride * size <= GPUS_PER_NODE \
            else NODE_NET_BW
        stride *= size
    return {name: out[name] for name in axes}

# --- Meili paper cluster calibration (§8 methodology, Figs 2/9/15) -----------
NIC_LINK_GBPS = 100.0
TO_CORE_GBPS_1500B = 100.0
PKT_BYTES = 1500


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    sms: int
    mem_bytes: int
    l2_bytes: int


def device_spec(index: int = 0) -> DeviceSpec:
    """The card's own SM count, memory and L2 when one is present, else the
    H100 SXM data sheet."""
    if torch.cuda.is_available():
        p = torch.cuda.get_device_properties(index)
        return DeviceSpec(name=p.name, sms=p.multi_processor_count,
                          mem_bytes=p.total_memory,
                          l2_bytes=getattr(p, "L2_cache_size", L2_BYTES))
    return DeviceSpec(name="H100 SXM (data sheet)", sms=NUM_SMS,
                      mem_bytes=HBM_BYTES, l2_bytes=L2_BYTES)


def peak_flops(*dtypes: torch.dtype) -> float:
    """The peak that holds for a product of operands of these dtypes: the
    bf16 tensor-core rate when every operand is bfloat16 or float16, else
    the f32-accurate tensor-core rate (3xTF32; an f32 operand keeps the
    math f32-accurate)."""
    if dtypes and all(d in (torch.bfloat16, torch.float16) for d in dtypes):
        return PEAK_BF16_TENSOR_FLOPS
    return PEAK_F32_TENSOR_FLOPS


def bound_seconds(nbytes: float, ops: float = 0.0,
                  peak: float = PEAK_ALU_OPS) -> tuple:
    """Least time for a function on the H100: the larger of its bytes over
    HBM bandwidth and its operations over ``peak`` (default the 32-bit ALU
    rate; ``peak_flops`` gives the rate for floating-point operands).
    Returns ``(seconds, "bytes" | "operations")``."""
    t_bytes = nbytes / HBM_BW
    t_ops = ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def resolve_device(device: Optional[object] = "cuda") -> torch.device:
    """``device=`` argument -> ``torch.device``. Asking for CUDA on a machine
    without a GPU raises; the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the port's plain PyTorch path on the CPU")
    return dev
