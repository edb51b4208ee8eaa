"""jamba-1.5-large-398b [arXiv:2403.19887; hf] — Mamba+attention 1:7, MoE 16e top-2.

72L, d_model=8192, 64H (GQA kv=8), d_ff=24576, vocab=65536. One attention
layer per 8 (the rest Mamba-2), MoE every 2nd layer. ssm: N=128, P=64
(d_inner=16384, 256 ssm heads); the reference keeps its optimizer state
in bf16. ~398 B parameters: on one card the port runs its ``reduced()``
config, and counts the full one's parameters on the meta device.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, d_head=128, n_experts=16, top_k=2,
    attn_period=8, moe_period=2, ssm_state=128, ssm_head_dim=64,
    ssm_expand=2, bf16_optimizer_state=True, tie_embeddings=False,
    microbatch=32)
