"""mamba2-370m [arXiv:2405.21060; unverified] — SSD, attention-free.

48L, d_model=1024, d_inner=2048, ssm_state N=128, head dim P=64 (H=32),
conv kernel 4, vocab=50280 (padded to 50432), tied embeddings. Decode
carries an O(1) state per layer: conv tails and the (H, N, P) SSM state.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True, microbatch=4)
