"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf] — 16e top-2.

32L, d_model=4096, 32H (GQA kv=8), per-expert d_ff=6400, vocab=32064.
~42 B parameters (~84 GB in bf16): on one card the port runs its
``reduced()`` config.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, d_head=128, n_experts=16, top_k=2,
    tie_embeddings=False, microbatch=16)
