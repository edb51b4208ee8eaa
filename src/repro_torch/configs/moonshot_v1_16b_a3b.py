"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf] — MoE 64e top-6.

48L, d_model=2048, 16H (kv=16), per-expert d_ff=1408, vocab=163840,
64 experts top-6, leading dense layer (DeepSeek-style stack), capacity
factor 1.25. ~27 B parameters as the reference builds it (the vocab-sized
embedding and every expert full width): ~54 GB in bf16, which one 80 GB
card serves at full width.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, d_head=128, n_experts=64, top_k=6, first_dense=1,
    tie_embeddings=True, microbatch=16)
