"""olmo-1b [arXiv:2402.00838; hf] — dense, non-parametric LayerNorm.

16L, d_model=2048, 16H (kv=16 = MHA), d_ff=8192, vocab=50304.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, nonparam_ln=True, tie_embeddings=True, microbatch=4)
