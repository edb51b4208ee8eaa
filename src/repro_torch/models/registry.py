"""Uniform model facade, as the reference's ``models/registry.py``.

``build(cfg)`` returns a Model exposing ``init`` (an ``lm.LM`` module on a
device), ``loss`` (training), ``forward``, ``prefill``, ``decode_step`` and
``init_cache`` over the dense, MoE, ssm and hybrid families, and
``param_struct``, ``input_specs`` and ``param_counts``, which give shapes
and dtypes on the meta device (no allocation; the port has no sharding
axes). encdec raises here (ROADMAP A21).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.hw import resolve_device
from repro_torch.models import lm as lm_mod

META = torch.device("meta")


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    # -- params ---------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             dtype=torch.bfloat16) -> lm_mod.LM:
        return lm_mod.init_lm(self.cfg, generator, dtype, self.device)

    def param_struct(self, dtype=torch.bfloat16) -> lm_mod.LM:
        """The parameters' shapes and dtypes: the LM built on the meta
        device."""
        return lm_mod.init_lm(self.cfg, torch.Generator(), dtype, META)

    def param_counts(self) -> Tuple[int, int]:
        """(total, active) parameter counts. Active discounts the routed
        experts' weights (a MoE layer's gate, up and down) by top_k /
        n_experts, as the reference does (MoE MODEL_FLOPS uses
        6·N_active·D)."""
        total = active = 0
        for name, p in self.param_struct().named_parameters():
            n = p.numel()
            total += n
            if ".moe." in name and not name.endswith(".router"):
                active += n * self.cfg.top_k // self.cfg.n_experts
            else:
                active += n
        return total, active

    # -- steps ------------------------------------------------------------------
    def loss(self, params: lm_mod.LM, batch: Dict[str, torch.Tensor],
             impl: Optional[str] = None) -> torch.Tensor:
        return lm_mod.lm_loss(self.cfg, params, batch["tokens"],
                              batch.get("patches"), impl=impl)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return lm_mod.init_cache(self.cfg, batch, max_len, dtype, self.device)

    def forward(self, params: lm_mod.LM, batch: Dict[str, torch.Tensor],
                impl: Optional[str] = None) -> torch.Tensor:
        return lm_mod.forward(self.cfg, params, batch.get("tokens"),
                              batch.get("patches"), impl)

    def prefill(self, params: lm_mod.LM, batch: Dict[str, torch.Tensor],
                max_len: int = 0, impl: Optional[str] = None,
                cache_dtype=torch.bfloat16):
        return lm_mod.prefill(self.cfg, params, batch.get("tokens"),
                              batch.get("patches"), max_len=max_len,
                              impl=impl, cache_dtype=cache_dtype)

    def decode_step(self, params: lm_mod.LM, cache, tokens: torch.Tensor,
                    impl: Optional[str] = None):
        return lm_mod.decode_step(self.cfg, params, cache, tokens, impl=impl)

    # -- input specs ----------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig, dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
        """Meta-device stand-ins for every model input of ``shape``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            if cfg.family == "vlm":
                tv = cfg.frontend_tokens
                return {"patches": torch.empty((B, tv, cfg.d_model),
                                               dtype=dtype, device=META),
                        "tokens": torch.empty((B, S - tv), dtype=torch.int32,
                                              device=META)}
            return {"tokens": torch.empty((B, S), dtype=torch.int32,
                                          device=META)}
        # decode: one new token against a seq_len cache
        return {"tokens": torch.empty((B,), dtype=torch.int32, device=META)}


def build(cfg: ArchConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (default the card; raises
    without one)."""
    if cfg.family == "encdec":
        raise NotImplementedError("encdec models are not ported yet: "
                                  "ROADMAP A21")
    return Model(cfg, resolve_device(device))
