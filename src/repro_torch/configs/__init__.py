"""Architecture configs the port runs. ``--arch <id>`` resolves here.

All ten architectures of the JAX package: dense gemma3-1b, olmo-1b,
minicpm-2b and qwen2.5-32b, ssm mamba2-370m, MoE moonshot-v1-16b-a3b and
phi3.5-moe-42b-a6.6b, hybrid jamba-1.5-large-398b, vlm llava-next-34b and
encdec seamless-m4t-medium. An unknown name raises ``KeyError``.
"""
from repro_torch.configs import (gemma3_1b, jamba_1_5_large_398b,
                                 llava_next_34b, mamba2_370m, minicpm_2b,
                                 moonshot_v1_16b_a3b, olmo_1b,
                                 phi3_5_moe_42b_a6_6b, qwen2_5_32b,
                                 seamless_m4t_medium)
from repro_torch.configs.base import ArchConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    seamless_m4t_medium, minicpm_2b, gemma3_1b, olmo_1b, qwen2_5_32b,
    moonshot_v1_16b_a3b, phi3_5_moe_42b_a6_6b, mamba2_370m, llava_next_34b,
    jamba_1_5_large_398b)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
