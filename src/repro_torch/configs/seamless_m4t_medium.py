"""seamless-m4t-medium [arXiv:2308.11596; hf] — enc-dec, multimodal (audio).

12L encoder + 12L decoder, d_model=1024, 16H (GQA kv=16 = MHA), d_ff=4096,
vocab=256206. The speech frontend is a stub: input_specs feeds precomputed
frame embeddings to the encoder (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=24, enc_layers=12, dec_layers=12, cross_attention=True,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    frontend="audio", tie_embeddings=True, microbatch=8)
