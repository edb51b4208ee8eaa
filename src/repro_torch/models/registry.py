"""Uniform model facade, as the reference's ``models/registry.py``.

``build(cfg)`` returns a Model exposing ``init`` (an ``lm.LM`` module on a
device), ``init_cache``, ``forward``, ``prefill`` and ``decode_step`` over
the dense and ssm families. ``loss``, ``param_struct`` and ``input_specs``
wait for the training slice (ROADMAP A19); encdec raises here, and the MoE
and hybrid families raise where their MoE layers are built (ROADMAP A20).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.hw import resolve_device
from repro_torch.models import lm as lm_mod


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    def init(self, generator: Optional[torch.Generator] = None,
             dtype=torch.bfloat16) -> lm_mod.LM:
        return lm_mod.init_lm(self.cfg, generator, dtype, self.device)

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


def build(cfg: ArchConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (default the card; raises
    without one)."""
    if cfg.family == "encdec":
        raise NotImplementedError("encdec models are not ported yet: "
                                  "ROADMAP A21")
    return Model(cfg, resolve_device(device))
