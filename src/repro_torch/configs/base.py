"""Architecture + shape configuration system (copied from the JAX package's
``configs/base.py``, which imports no JAX, so that the port imports nothing
of it).

One `ArchConfig` per assigned architecture (exact public-literature configs);
`reduced()` derives the CPU smoke-test variant (same family, tiny dims).
`SHAPES` defines the four assigned input-shape cells; applicability masks
(long_500k needs sub-quadratic attention) live here so the dry run,
the tests and EXPERIMENTS.md agree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 => d_model // n_heads

    # attention flavor
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: Optional[int] = None     # sliding window for local layers
    local_global_period: int = 0     # gemma3: one global layer per period
    nonparam_ln: bool = False        # olmo: non-parametric LayerNorm

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    first_dense: int = 0             # leading dense layers before MoE stack

    # SSM (Mamba-2)
    ssm_state: int = 0               # N
    ssm_head_dim: int = 0            # P
    ssm_expand: int = 2
    conv_kernel: int = 4

    # hybrid (jamba): one attention layer per `attn_period` layers,
    # MoE every `moe_period` layers.
    attn_period: int = 0
    moe_period: int = 0

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    cross_attention: bool = False

    # modality frontend stub
    frontend: Optional[str] = None   # "audio" | "vision"
    frontend_tokens: int = 0         # stub positions prepended to the text seq

    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # training
    schedule: str = "cosine"         # "cosine" | "wsd" (minicpm)
    microbatch: int = 16             # grad-accumulation steps for train_4k
    remat: bool = True
    bf16_optimizer_state: bool = False   # jamba-398B: fits 16 GB/chip this way

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:        # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        kw: Dict = dict(
            n_layers=min(self.n_layers, 4), d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128, vocab=512, d_head=16, microbatch=1)
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=8)
        if self.window:
            kw.update(window=16)
        if self.local_global_period:
            kw.update(local_global_period=2, n_layers=4)
        if self.attn_period:
            kw.update(attn_period=4, moe_period=2, n_layers=8)
        if self.enc_layers:
            kw.update(enc_layers=2, dec_layers=2)
        if self.first_dense:
            kw.update(first_dense=1)
        if self.frontend_tokens:
            kw.update(frontend_tokens=8)
        return self.replace(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Pure full-attention archs skip long_500k (sub-quadratic attention required).
SUBQUADRATIC = {"gemma3-1b", "mamba2-370m", "jamba-1.5-large-398b"}


def cells(arch_name: str) -> List[Tuple[str, str]]:
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and arch_name not in SUBQUADRATIC:
            continue
        out.append((arch_name, s.name))
    return out


def skipped_cells(arch_name: str) -> List[Tuple[str, str, str]]:
    if arch_name in SUBQUADRATIC:
        return []
    return [(arch_name, "long_500k",
             "pure full attention — long_500k needs sub-quadratic attention")]
