"""gemma3-1b [hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global, 128k.

26L, d_model=1152, 4H (GQA kv=1 = MQA), d_ff=6912, vocab=262144,
head_dim=256, sliding window 512 on local layers, one global layer per 6.
long_500k RUNS: 5/6 of layers are O(W·S); decode is O(S)/token.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab=262144, d_head=256, window=512, local_global_period=6,
    rope_theta=1e6, tie_embeddings=True, microbatch=4)
