"""llava-next-34b [hf:llava-hf/llava-v1.6-*; unverified] — VLM, anyres tiling.

60L, d_model=7168, 56H (GQA kv=8), d_ff=20480, vocab=64000, head_dim=128.
Vision frontend is a stub: input_specs provides 576 precomputed patch
embeddings per image, prepended to the text sequence (anyres tiles are
flows of patch-packets in the Meili example). long_500k SKIPPED.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, d_head=128, frontend="vision", frontend_tokens=576,
    tie_embeddings=False, microbatch=16)
