"""Architecture configs the port runs. ``--arch <id>`` resolves here.

Only the configs whose every module is ported are known (dense gemma3-1b
and olmo-1b, ssm mamba2-370m, MoE moonshot-v1-16b-a3b and
phi3.5-moe-42b-a6.6b, hybrid jamba-1.5-large-398b); every other
architecture of the JAX package raises ``KeyError`` naming the ROADMAP item
that ports what it needs.
"""
from repro_torch.configs import (gemma3_1b, jamba_1_5_large_398b, mamba2_370m,
                                 moonshot_v1_16b_a3b, olmo_1b,
                                 phi3_5_moe_42b_a6_6b)
from repro_torch.configs.base import ArchConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    gemma3_1b, olmo_1b, moonshot_v1_16b_a3b, phi3_5_moe_42b_a6_6b,
    mamba2_370m, jamba_1_5_large_398b)}

# Architectures of the JAX package that wait for a later slice.
PENDING = {
    "minicpm-2b": "ROADMAP A21 (remaining dense, vlm and encdec configs)",
    "qwen2.5-32b": "ROADMAP A21 (remaining dense, vlm and encdec configs)",
    "llava-next-34b": "ROADMAP A21 (remaining dense, vlm and encdec configs)",
    "seamless-m4t-medium": "ROADMAP A21 (remaining dense, vlm and encdec "
                           "configs)",
}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PENDING:
        raise KeyError(f"arch {name!r} is not ported yet: {PENDING[name]}")
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
