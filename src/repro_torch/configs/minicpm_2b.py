"""minicpm-2b [arXiv:2404.06395; hf] — dense llama-like, WSD schedule.

40L, d_model=2304, 36H (GQA kv=36 = MHA), d_ff=5760, vocab=122753.
36 heads do not divide a 16-way model axis: ``rules_for`` picks the
fully-sharded data-parallel table for it (``parallel/sharding.py``; no
head_dim fallback by default).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, d_head=64, schedule="wsd", tie_embeddings=True,
    microbatch=8)
