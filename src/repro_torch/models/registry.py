"""Uniform model facade, as the reference's ``models/registry.py``.

``build(cfg)`` returns a Model exposing ``init`` (an ``lm.LM`` module on a
device), ``loss`` (training), ``forward``, ``prefill``, ``decode_step`` and
``init_cache`` over every family (dense, vlm, MoE, ssm, hybrid through
``models/lm.py``; encdec through ``models/encdec.py``), and
``param_struct``, ``input_specs``, ``cache_struct`` and ``param_counts``,
which give shapes and dtypes on the meta device (no allocation), and
``param_axes`` and ``cache_axes``, the logical axes that
``parallel/sharding.py`` resolves against a mesh.

The port holds one module per layer where the reference stacks a segment's
layers on a leading ``"layers"`` axis, which no rule table shards: a
parameter's axes here are the reference leaf's without that entry. The
decode cache keeps the reference's stacked layout, and its axes keep the
``"layers"`` entry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.hw import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.parallel import sharding

# The families whose steps run partitioned over a DeviceMesh
# (``launch/steps.py`` with a mesh).
PARTITIONED_FAMILIES = ("dense", "ssm", "moe", "hybrid", "encdec", "vlm")

META = torch.device("meta")

# Logical axes of a parameter by its block and its path inside the block,
# as the reference's init functions assign them (layers.py, attention.py,
# ssm.py, moe.py).
_ATTN_AXES = {
    "q.w": ("embed", "heads", "head_dim"),
    "k.w": ("embed", "kv_heads", "head_dim"),
    "v.w": ("embed", "kv_heads", "head_dim"),
    "q.b": ("heads", "head_dim"),
    "k.b": ("kv_heads", "head_dim"),
    "v.b": ("kv_heads", "head_dim"),
    "o.w": ("heads", "head_dim", "embed"),
}
_BLOCK_AXES = {
    "attn": _ATTN_AXES, "self": _ATTN_AXES, "cross": _ATTN_AXES,
    "mlp": {"gate.w": ("embed", "ff"), "up.w": ("embed", "ff"),
            "down.w": ("ff", "embed")},
    "moe": {"router": ("vocab_embed", "none"),
            "gate": ("experts", "embed", "expert_ff"),
            "up": ("experts", "embed", "expert_ff"),
            "down": ("experts", "expert_ff", "embed")},
    "mamba": {"z.w": ("embed", "ff"), "x.w": ("embed", "ff"),
              "B.w": ("embed", "state"), "C.w": ("embed", "state"),
              "dt.w": ("embed", "none"), "o.w": ("ff", "embed"),
              "norm.scale": ("none",), "conv_x": ("conv", "ff"),
              "conv_BC": ("conv", "none"), "A_log": ("none",),
              "dt_bias": ("none",), "D_skip": ("none",)},
}
_TOP_AXES = {"embed.table": ("vocab", "vocab_embed"),
             "head.w": ("vocab_embed", "vocab")}
_KV_AXES = lm_mod.KV_CACHE_AXES
_MAMBA_CACHE_AXES = lm_mod.MAMBA_CACHE_AXES


def param_axes_of(name: str) -> Tuple[str, ...]:
    """The logical axes of the parameter called ``name``
    (``named_parameters()``)."""
    if name in _TOP_AXES:
        return _TOP_AXES[name]
    parts = name.split(".")
    for i, part in enumerate(parts):
        if part in _BLOCK_AXES:
            return _BLOCK_AXES[part][".".join(parts[i + 1:])]
    if parts[-1] == "scale":                       # a norm's
        return ("none",)
    raise KeyError(f"no logical axes for parameter {name!r}")


def cache_leaves(cache) -> Dict[str, torch.Tensor]:
    """A decode cache's tensors, flat: ``segments.<i>.<position>.<leaf>``
    for the LM families, the leaf names for encdec (``pos`` is a Python
    int and carries no axes)."""
    if "segments" not in cache:
        return {k: t for k, t in cache.items() if k != "pos"}
    return {f"segments.{i}.{j}.{k}": t
            for i, seg in enumerate(cache["segments"])
            for j, c in enumerate(seg) for k, t in c.items()}


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    # -- params ---------------------------------------------------------------
    @property
    def encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def init(self, generator: Optional[torch.Generator] = None,
             dtype=torch.bfloat16):
        """An ``lm.LM``, or an ``encdec.EncDec`` for the encdec family."""
        if self.encdec:
            return encdec_mod.init_encdec(self.cfg, generator, dtype,
                                          self.device)
        return lm_mod.init_lm(self.cfg, generator, dtype, self.device)

    def param_struct(self, dtype=torch.bfloat16):
        """The parameters' shapes and dtypes: the model built on the meta
        device."""
        init = encdec_mod.init_encdec if self.encdec else lm_mod.init_lm
        return init(self.cfg, torch.Generator(), dtype, META)

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

    def param_axes(self) -> Dict[str, Tuple[str, ...]]:
        """``{parameter name: logical axes}``, from the structure on the
        meta device (nothing is allocated)."""
        return {n: param_axes_of(n)
                for n, _ in self.param_struct().named_parameters()}

    def cache_axes(self) -> Dict[str, Tuple[str, ...]]:
        """The decode cache's logical axes, keyed as ``cache_leaves``."""
        if self.encdec:
            return {k: _KV_AXES for k in ("self_k", "self_v", "cross_k",
                                          "cross_v")}
        out = {}
        for i, seg in enumerate(lm_mod.build_schedule(self.cfg)):
            for j, spec in enumerate(seg.body):
                leaves = ({"k": _KV_AXES, "v": _KV_AXES}
                          if spec.mixer in ("attn", "attn_local")
                          else _MAMBA_CACHE_AXES)
                for k, ax in leaves.items():
                    out[f"segments.{i}.{j}.{k}"] = ax
        return out

    # -- steps ------------------------------------------------------------------
    def loss(self, params, batch: Dict[str, torch.Tensor],
             impl: Optional[str] = None) -> torch.Tensor:
        if self.encdec:
            return encdec_mod.encdec_loss(self.cfg, params, batch["frames"],
                                          batch["tokens"], impl=impl)
        return lm_mod.lm_loss(self.cfg, params, batch["tokens"],
                              batch.get("patches"), impl=impl)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        if self.encdec:
            return encdec_mod.init_cache_encdec(self.cfg, batch, max_len,
                                                dtype, self.device)
        return lm_mod.init_cache(self.cfg, batch, max_len, dtype, self.device)

    def forward(self, params, batch: Dict[str, torch.Tensor],
                impl: Optional[str] = None) -> torch.Tensor:
        if self.encdec:
            enc = encdec_mod.encode(self.cfg, params, batch["frames"], impl)
            return encdec_mod.decode_train(self.cfg, params, batch["tokens"],
                                           enc, impl)
        return lm_mod.forward(self.cfg, params, batch.get("tokens"),
                              batch.get("patches"), impl)

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                max_len: int = 0, impl: Optional[str] = None,
                cache_dtype=torch.bfloat16):
        """(last position's logits, cache). encdec returns no cache, as the
        reference's prefill does (``max_len`` and ``cache_dtype`` unused
        there)."""
        if self.encdec:
            return encdec_mod.prefill(self.cfg, params, batch["frames"],
                                      batch["tokens"], impl=impl)
        return lm_mod.prefill(self.cfg, params, batch.get("tokens"),
                              batch.get("patches"), max_len=max_len,
                              impl=impl, cache_dtype=cache_dtype)

    def decode_step(self, params, cache, tokens: torch.Tensor,
                    impl: Optional[str] = None):
        if self.encdec:
            return encdec_mod.decode_step_encdec(self.cfg, params, cache,
                                                 tokens, impl=impl)
        return lm_mod.decode_step(self.cfg, params, cache, tokens, impl=impl)

    # -- input specs ----------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig, dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
        """Meta-device stand-ins for every model input of ``shape``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            if self.encdec:         # seq_len split evenly: frames, tokens
                half = S // 2
                return {"frames": torch.empty((B, half, cfg.d_model),
                                              dtype=dtype, device=META),
                        "tokens": torch.empty((B, half), dtype=torch.int32,
                                              device=META)}
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

    def input_axes(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        """The logical axes of every input of ``shape``, as the reference's
        ``input_specs`` gives them."""
        if shape.kind == "decode":
            return {"tokens": ("batch",)}
        out = {"tokens": ("batch", "seq")}
        if self.encdec:
            out["frames"] = ("batch", "seq", "embed_act")
        elif self.cfg.family == "vlm":
            out["patches"] = ("batch", "seq", "embed_act")
        return out

    def distribute(self, params, mesh, rules):
        """``params`` (an ``LM`` or an ``EncDec`` whose tensors are whole
        and the same on every rank: from ``init`` with one seed, or the
        JAX package's through ``convert``) with every parameter replaced,
        in place, by a DTensor on the live ``mesh`` placed by the resolver
        (``sharding.distribute``; each rank keeps its block, no
        collective; a MoE layer's expert weights are split over their
        experts, so each rank holds its experts' block; the encoder's and
        decoder's layers by their ``attn``, ``self``, ``cross`` and
        ``mlp`` blocks). Gradients stay switched as they were. Every
        family (``PARTITIONED_FAMILIES``)."""
        if self.cfg.family not in PARTITIONED_FAMILIES:
            raise NotImplementedError(
                f"the partitioned step of the {self.cfg.family} family is "
                f"not ported (only {PARTITIONED_FAMILIES})")
        named = dict(params.named_parameters())
        placed = sharding.distribute({k: p.detach() for k, p in
                                      named.items()},
                                     self.param_axes(), rules, mesh)
        for k, d in placed.items():
            path, _, leaf = k.rpartition(".")
            mod = params.get_submodule(path)
            mod.register_parameter(leaf, torch.nn.Parameter(
                d, requires_grad=named[k].requires_grad))
        return params

    def cache_struct(self, shape: ShapeConfig, dtype=torch.bfloat16):
        """The decode cache of ``shape`` (batch, seq_len deep) on the meta
        device."""
        B, S = shape.global_batch, shape.seq_len
        if self.encdec:
            return encdec_mod.init_cache_encdec(self.cfg, B, S, dtype, META)
        return lm_mod.init_cache(self.cfg, B, S, dtype, META)


def build(cfg: ArchConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (default the card; raises
    without one)."""
    return Model(cfg, resolve_device(device))
