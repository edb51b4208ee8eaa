"""Decoder LM over a *layer schedule*: the dense, MoE, ssm and hybrid
families.

A schedule is a list of Segments; each Segment has a ``body`` (an ordered
tuple of LayerSpec — mixer x ffn kinds) repeated ``count`` times. The
reference scans each segment over stacked parameters; here the layers are
``DecoderLayer`` modules held in one ``nn.ModuleList`` per segment, in the
order the scan visits them: repetition, then body position. gemma3's 5:1
local:global pattern is a 6-layer body x4 plus a 2-layer tail; mamba2's
48 mamba layers (no MLP) are one segment; moonshot's leading dense layer
is a segment of its own before 47 attention + MoE layers; jamba's 8-layer
body puts attention at position 4 among mamba layers and a MoE FFN on
every odd position.

Each Segment is a Meili pipeline *stage* with its own profiled latency
(``serving/planner.py``). The cache keeps the reference's layout: per
segment, per body position, a dict of leaves stacked over the repetitions —
``{"k", "v"}`` (count, B, max_len, Hkv, dh) for attention, ``{"conv_x",
"conv_BC", "h"}`` for mamba — and ``decode_step`` updates it in place;
``cache["pos"]`` is a Python int shared by every row, as the reference's
scalar is.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.hw import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import remat
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, embed, embed_init,
                                       make_norm, mlp, mlp_init, pad_vocab,
                                       to_module)
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding

Tree = Dict


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # "attn" | "attn_local" | "mamba"
    ffn: str            # "mlp" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class Segment:
    body: Tuple[LayerSpec, ...]
    count: int


def build_schedule(cfg) -> List[Segment]:
    L = cfg.n_layers
    if cfg.family == "ssm":
        return [Segment((LayerSpec("mamba", "none"),), L)]
    if cfg.family == "hybrid":
        period, body = cfg.attn_period, []
        for i in range(period):
            mixer = "attn" if i == period // 2 else "mamba"
            ffn = "moe" if (i % cfg.moe_period == 1) else "mlp"
            body.append(LayerSpec(mixer, ffn))
        assert L % period == 0, (L, period)
        return [Segment(tuple(body), L // period)]
    if cfg.family == "moe":
        segs = []
        if cfg.first_dense:
            segs.append(Segment((LayerSpec("attn", "mlp"),), cfg.first_dense))
        segs.append(Segment((LayerSpec("attn", "moe"),), L - cfg.first_dense))
        return segs
    # dense / vlm
    if cfg.local_global_period:
        per = cfg.local_global_period
        body = tuple([LayerSpec("attn_local", "mlp")] * (per - 1)
                     + [LayerSpec("attn", "mlp")])
        segs = [Segment(body, L // per)]
        if L % per:
            segs.append(Segment((LayerSpec("attn_local", "mlp"),), L % per))
        return segs
    return [Segment((LayerSpec("attn", "mlp"),), L)]


# ---------------------------------------------------------------------------
# Modules + init
# ---------------------------------------------------------------------------

def _is_attn(spec: LayerSpec) -> bool:
    return spec.mixer in ("attn", "attn_local")


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: norm1 -> mixer (attention or mamba) ->
    residual, then, unless ``ffn`` is "none", norm2 -> MLP or MoE ->
    residual. Parameters are nested dicts keyed as the reference's layer
    tree (``norm1``, ``attn`` or ``mamba``, ``norm2``, ``mlp`` or
    ``moe``)."""

    def __init__(self, cfg, spec: LayerSpec, params: Mapping):
        super().__init__()
        self.spec = spec
        self.norm1 = to_module(params["norm1"])
        if _is_attn(spec):
            self.attn = to_module(params["attn"])
        else:
            self.mamba = to_module(params["mamba"])
        if spec.ffn != "none":
            self.norm2 = to_module(params["norm2"])
            setattr(self, spec.ffn, to_module(params[spec.ffn]))


def layer_init(gen: torch.Generator, cfg, spec: LayerSpec, dtype,
               device) -> Tree:
    norm_init, _ = make_norm(cfg)
    p = {"norm1": norm_init(dtype, device)}
    if _is_attn(spec):
        p["attn"] = attn_mod.attn_init(gen, cfg, dtype, device)
    else:
        p["mamba"] = ssm_mod.mamba_init(gen, cfg, dtype, device)
    if spec.ffn == "mlp":
        p["norm2"] = norm_init(dtype, device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    elif spec.ffn == "moe":
        p["norm2"] = norm_init(dtype, device)
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device)
    return p


class LM(nn.Module):
    """Embedding, the schedule's layers, final norm (and an untied head).
    ``segments[i]`` lists segment i's layers repetition-major."""

    def __init__(self, cfg, embed: Mapping, segments: List[List[Mapping]],
                 final_norm: Mapping, head: Optional[Mapping] = None):
        super().__init__()
        self.cfg = cfg
        schedule = build_schedule(cfg)
        self.embed = to_module(embed)
        self.head = to_module(head) if head is not None else None
        self.segments = nn.ModuleList()
        for seg, seg_ps in zip(schedule, segments):
            specs = [seg.body[i % len(seg.body)]
                     for i in range(seg.count * len(seg.body))]
            self.segments.append(nn.ModuleList(
                DecoderLayer(cfg, spec, p) for spec, p in zip(specs, seg_ps)))
        self.final_norm = to_module(final_norm)

    def layers(self, seg: int, rep: int) -> List[DecoderLayer]:
        """Segment ``seg``'s layers of repetition ``rep``, in body order."""
        n = len(build_schedule(self.cfg)[seg].body)
        return list(self.segments[seg][rep * n:(rep + 1) * n])

    def all_layers(self) -> Iterator[Tuple[int, int, int, DecoderLayer]]:
        """(segment, repetition, body position, layer) in scan order."""
        for si, seg in enumerate(build_schedule(self.cfg)):
            for rep in range(seg.count):
                for bpos, layer in enumerate(self.layers(si, rep)):
                    yield si, rep, bpos, layer


def init_lm(cfg, generator: Optional[torch.Generator] = None,
            dtype=torch.bfloat16, device="cuda") -> LM:
    """Parameters drawn as the reference draws them (normal, 1/sqrt(fan-in)
    scale; norms at 1) from ``generator`` (a fresh one seeded 0 on the
    device when None)."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    table = embed_init(gen, cfg.vocab, cfg.d_model, dtype, dev)
    head = None
    if not cfg.tie_embeddings:
        head = dense_init(gen, cfg.d_model, pad_vocab(cfg.vocab), dtype, dev)
    segments = []
    for seg in build_schedule(cfg):
        segments.append([layer_init(gen, cfg, seg.body[i % len(seg.body)],
                                    dtype, dev)
                         for i in range(seg.count * len(seg.body))])
    norm_init, _ = make_norm(cfg)
    return LM(cfg, table, segments, norm_init(dtype, dev), head)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _apply_layer(cfg, layer: DecoderLayer, x: torch.Tensor,
                 positions: torch.Tensor, impl: Optional[str],
                 collect_kv: bool = False):
    """One layer of a full-sequence pass; with ``collect_kv`` also its
    decode-cache entry: (k, v) for attention, the mamba cache dict."""
    _, norm_apply = make_norm(cfg)
    spec = layer.spec
    h = norm_apply(layer.norm1, x)
    if _is_attn(spec):
        window = cfg.window if spec.mixer == "attn_local" else None
        out = attn_mod.attn_apply(layer.attn, h, cfg, positions=positions,
                                  causal=True, window=window, impl=impl,
                                  return_kv=collect_kv)
    else:
        out = ssm_mod.mamba_apply(layer.mamba, h, cfg, impl=impl,
                                  return_state=collect_kv)
    y, kv = out if collect_kv else (out, None)
    x = sharding.constrain_act(x + y, ("batch", "seq", None))
    if spec.ffn != "none":
        h = norm_apply(layer.norm2, x)
        y = (moe_mod.moe_ffn(layer.moe, h, cfg) if spec.ffn == "moe"
             else mlp(layer.mlp, h))
        x = sharding.constrain_act(x + y, ("batch", "seq", None))
    return x, kv


def _embed_inputs(params: LM, tokens: Optional[torch.Tensor],
                  extra_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    parts = []
    if extra_embeds is not None:
        parts.append(extra_embeds)
    if tokens is not None:
        # pinned: a vocab-parallel lookup leaves a partial sum
        parts.append(sharding.constrain_act(embed(params.embed, tokens),
                                            ("batch", "seq", None)))
    if len(parts) == 1:
        return parts[0]
    return torch.cat([parts[0].to(parts[1].dtype), parts[1]], dim=1)


def positions_of(x: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 positions 0..S-1 of a (B, S, D) activation: a
    DTensor's global ones; for a rank's plain block of installed tokens
    whose sequence is split over ranks, its block's global positions."""
    B, S = x.shape[:2]
    entry = sharding.token_seq_entry()
    start = 0 if entry is None else \
        sharding.block_index(entry, sharding.installed()[1])[0] * S
    return torch.arange(start, start + S, dtype=torch.int32,
                        device=x.device)[None].expand(B, S)


def forward(cfg, params: LM, tokens: Optional[torch.Tensor],
            extra_embeds: Optional[torch.Tensor] = None,
            impl: Optional[str] = None) -> torch.Tensor:
    """Returns final hidden states (B, S, D). Differentiable: autograd
    records it where parameters require gradients (training). With
    ``cfg.remat`` each repetition of a segment's body (the reference's
    scanned ``body``: one layer, gemma's local/global pair, jamba's 8)
    runs under ``remat.checkpoint`` when autograd records."""
    x = _embed_inputs(params, tokens, extra_embeds)
    positions = positions_of(x)
    for si, seg in enumerate(build_schedule(cfg)):
        for rep in range(seg.count):
            x = remat.maybe(cfg, _apply_body, cfg, params.layers(si, rep),
                            x, positions, impl)
    _, norm_apply = make_norm(cfg)
    return norm_apply(params.final_norm, x)


def _apply_body(cfg, layers: List[DecoderLayer], x: torch.Tensor,
                positions: torch.Tensor, impl: Optional[str]
                ) -> torch.Tensor:
    """One repetition of a segment's body: its layers in order."""
    for layer in layers:
        x, _ = _apply_layer(cfg, layer, x, positions, impl)
    return x


def vocab_bias(cfg, dtype=torch.float32, device=None) -> torch.Tensor:
    """(pad_vocab,) additive mask: 0 for real tokens, NEG_INF for padding."""
    vp = pad_vocab(cfg.vocab)
    ids = torch.arange(vp, device=device)
    return torch.where(ids < cfg.vocab, 0.0, -1e30).to(dtype)


def logits(cfg, params: LM, x: torch.Tensor) -> torch.Tensor:
    w = params.embed["table"].T if cfg.tie_embeddings else params.head["w"]
    return (x @ w).float() + vocab_bias(cfg, device=x.device)


def lm_loss(cfg, params: LM, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None,
            impl: Optional[str] = None, chunk: int = 512) -> torch.Tensor:
    """Next-token cross-entropy, as the reference's ``lm_loss``: the
    (S, vocab) logits are made chunk by chunk. Two of its details are
    mirrored as they are: the logits carry no ``vocab_bias``, so the
    padded vocab rows enter the log-sum-exp, and the predictions past the
    last whole chunk are dropped (511 of 1,023 at S 1,024)."""
    x = forward(cfg, params, tokens, extra_embeds, impl)
    offset = 0 if extra_embeds is None else extra_embeds.shape[1]
    return chunked_ce(cfg, params, x, tokens, offset, chunk)


def chunked_ce(cfg, params: LM, x: torch.Tensor, tokens: torch.Tensor,
               offset: int = 0, chunk: int = 512) -> torch.Tensor:
    """``lm_loss`` of the final hidden states ``x`` (B, S, D), whose text
    starts at ``offset``."""
    xs = x[:, offset:offset + tokens.shape[1] - 1]            # predict text
    tgt = tokens[:, 1:].long()
    B, S, _ = xs.shape
    chunk = min(chunk, S)
    n = S // chunk
    w = params.embed["table"].T if cfg.tie_embeddings else params.head["w"]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        lg = (xs[:, i * chunk:(i + 1) * chunk] @ w).float()  # (B, c, V)
        lse = torch.logsumexp(lg, dim=-1)
        tc = tgt[:, i * chunk:(i + 1) * chunk, None]
        total = total + (lse - _target_logits(lg, tc)).sum()
    return total / (B * n * chunk)


def _target_logits(lg: torch.Tensor, tc: torch.Tensor) -> torch.Tensor:
    """lg's entry at each target tc (..., 1): a gather, or over logits
    split by vocab (a DTensor) the sum of the entries the target picks,
    which is the same value: every other term is an exact zero."""
    if not sharding.is_dtensor(lg):
        return lg.gather(-1, tc)[..., 0]
    ids = torch.arange(lg.shape[-1], device=tc.device)
    return torch.where(ids == tc, lg, 0.0).sum(-1)


def prefill_layer(cfg, layer: DecoderLayer, x: torch.Tensor,
                  positions: torch.Tensor, impl: Optional[str],
                  c: Dict[str, torch.Tensor], rep: int, count: int,
                  cache_dtype) -> torch.Tensor:
    """One layer of ``prefill``: the layer's pass, then its cache entry
    written into repetition ``rep`` of its body position's stacked cache
    ``c`` (a mamba leaf is made at repetition 0, in the first state's
    dtype)."""
    x, kv = _apply_layer(cfg, layer, x, positions, impl, collect_kv=True)
    if _is_attn(layer.spec):
        _write_prefix(c["k"], rep, kv[0].to(cache_dtype))
        _write_prefix(c["v"], rep, kv[1].to(cache_dtype))
        return x
    for k, t in kv.items():
        t = t if t.dtype == torch.float32 else t.to(cache_dtype)
        if sharding.is_dtensor(t) and any(q.is_partial()
                                          for q in t.placements):
            # the SSD's state over a split sequence: a partial sum
            from torch.distributed.tensor import Replicate
            t = t.redistribute(t.device_mesh, [
                Replicate() if q.is_partial() else q for q in t.placements])
        if rep == 0 and sharding.is_dtensor(t):
            c[k] = _cache_zeros(t.device, t.device_mesh)(
                (count,) + tuple(t.shape), MAMBA_CACHE_AXES[k], t.dtype)
        elif rep == 0:
            c[k] = t.new_empty((count,) + t.shape)
        c[k][rep] = t
    return x


def _write_prefix(leaf: torch.Tensor, rep: int, kv: torch.Tensor) -> None:
    """``leaf[rep, :, :S] = kv``: a prefill's keys or values kv (B, S,
    Hkv, dh) into repetition ``rep`` of a stacked cache leaf (count, B,
    max_len, Hkv, dh). Where the rules split the cache's keys or the
    prefill's sequence over ranks, each rank writes the rows of its block
    of the cache: its own block of kv where the two blocks coincide
    (max_len == S), else from kv gathered over the sequence's axes. A
    rank's plain block of installed tokens whose sequence is split writes
    the gathered kv into its whole-depth cache."""
    if not (sharding.is_dtensor(leaf) and (
            sharding.split_entry(leaf, 2) or sharding.split_entry(kv, 1))):
        entry = sharding.token_seq_entry()
        if entry is not None and not sharding.is_dtensor(kv):
            kv = collectives.gather_dim(kv, entry, sharding.installed()[1],
                                        1)
        leaf[rep, :, :kv.shape[1]] = kv
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = leaf.device_mesh
    target = [Shard(1) if q_kv == Shard(1) else
              Shard(q.dim - 1) if isinstance(q, Shard) and q.dim != 2 else
              Replicate() for q, q_kv in zip(leaf.placements, kv.placements)]
    kv = kv.redistribute(mesh, target)
    src, block = kv.to_local(), leaf.to_local()[rep]
    kv_entry, leaf_entry = (sharding.split_entry(kv, 1),
                            sharding.split_entry(leaf, 2))
    Mb = block.shape[1]
    if kv_entry == leaf_entry and src.shape[1] == Mb:
        block.copy_(src)
        return
    if kv_entry is not None:
        src = collectives.gather_dim(src, kv_entry, mesh, 1)
    r = sharding.block_index(leaf_entry, mesh)[0] if leaf_entry else 0
    lo, hi = r * Mb, min((r + 1) * Mb, src.shape[1])
    if hi > lo:
        block[:, :hi - lo] = src[:, lo:hi]


# ---------------------------------------------------------------------------
# Decode + cache
# ---------------------------------------------------------------------------

# Logical axes of the stacked cache leaves (``parallel/sharding.py``).
KV_CACHE_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
MAMBA_CACHE_AXES = {"conv_x": ("layers", "batch", "conv", "ff"),
                    "conv_BC": ("layers", "batch", "conv", "none"),
                    "h": ("layers", "batch", "none", "cache_state", "none")}


def _cache_zeros(dev, mesh=None):
    """zeros(shape, axes, dtype): a plain tensor on ``dev``, or with a live
    ``mesh`` a DTensor placed by the installed rules (each rank allocates
    its block)."""
    if mesh is None:
        return lambda shape, axes, dtype: torch.zeros(shape, dtype=dtype,
                                                      device=dev)
    rules = sharding.installed()[0]
    return lambda shape, axes, dtype: sharding.dzeros(shape, axes, rules,
                                                      mesh, dtype, dev)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", mesh=None) -> Tree:
    """Stacked per-segment caches, zeros, ``pos`` 0. A mamba layer's SSM
    state is f32 whatever ``dtype`` is, as in the reference. With a live
    ``mesh``, DTensors placed by the installed rules."""
    return _new_cache(cfg, batch, max_len, dtype, resolve_device(device),
                      with_mamba=True, mesh=mesh)


def _new_cache(cfg, batch: int, max_len: int, dtype, dev,
               with_mamba: bool, mesh=None) -> Tree:
    """``init_cache``'s caches; without ``with_mamba`` a mamba position is
    an empty dict, for ``prefill`` to fill with the states it computes."""
    cache: Tree = {"pos": 0, "segments": []}
    zeros = _cache_zeros(dev, mesh)
    for seg in build_schedule(cfg):
        seg_c = []
        for spec in seg.body:
            if _is_attn(spec):
                kshape = (seg.count, batch, max_len, cfg.n_kv_heads,
                          cfg.head_dim)
                c = {"k": zeros(kshape, KV_CACHE_AXES, dtype),
                     "v": zeros(kshape, KV_CACHE_AXES, dtype)}
            elif with_mamba:
                c0 = ssm_mod.mamba_cache_init(cfg, batch, dtype,
                                              torch.device("meta"))
                c = {k: zeros((seg.count,) + tuple(t.shape),
                              MAMBA_CACHE_AXES[k], t.dtype)
                     for k, t in c0.items()}
            else:
                c = {}
            seg_c.append(c)
        cache["segments"].append(seg_c)
    return cache


def layer_cache(c: Mapping[str, torch.Tensor], rep: int
                ) -> Dict[str, torch.Tensor]:
    """Repetition ``rep``'s slice of a body position's stacked cache: views,
    so writing them writes the cache."""
    return {k: t[rep] for k, t in c.items()}


def _promote_tails(c: Dict[str, torch.Tensor], dtype: torch.dtype) -> None:
    """The reference's decode concatenates a conv tail with the new row, so
    a bf16 tail (``init_cache(dtype=bf16)``) comes back in the promoted
    dtype (f32 for f32 activations) after one step; the port promotes the
    stacked leaf once, then writes it in place."""
    for k in ("conv_x", "conv_BC"):
        want = torch.promote_types(c[k].dtype, dtype)
        if c[k].dtype != want:
            c[k] = c[k].to(want)


def decode_layer(cfg, layer: DecoderLayer, h: torch.Tensor,
                 cache: Mapping[str, torch.Tensor], pos: int,
                 impl: Optional[str]) -> torch.Tensor:
    """One layer of one decode step; ``cache`` is the layer's slice of the
    cache (``layer_cache``), written in place."""
    _, norm_apply = make_norm(cfg)
    hn = norm_apply(layer.norm1, h)
    if _is_attn(layer.spec):
        window = cfg.window if layer.spec.mixer == "attn_local" else None
        h = h + attn_mod.attn_decode(layer.attn, hn, cfg,
                                     cache_k=cache["k"], cache_v=cache["v"],
                                     pos=pos, window=window, impl=impl)
    else:
        h = h + ssm_mod.mamba_decode(layer.mamba, hn, cache, cfg)
    if layer.spec.ffn == "none":
        return h
    hn = norm_apply(layer.norm2, h)
    if layer.spec.ffn == "moe":
        return h + moe_mod.moe_ffn(layer.moe, hn[:, None], cfg)[:, 0]
    return h + mlp(layer.mlp, hn)


@torch.no_grad()
def decode_step(cfg, params: LM, cache: Tree, tokens: torch.Tensor,
                impl: Optional[str] = None) -> Tuple[torch.Tensor, Tree]:
    """One decode step. tokens: (B,) int. Writes the new keys and values
    (or conv tails and SSM states) into ``cache`` in place, advances
    ``cache["pos"]`` and returns (logits (B, V), cache)."""
    _, norm_apply = make_norm(cfg)
    x = sharding.constrain_act(embed(params.embed, tokens),
                               ("batch", None))              # (B, D)
    pos = int(cache["pos"])
    for si, rep, bpos, layer in params.all_layers():
        c = cache["segments"][si][bpos]
        if rep == 0 and not _is_attn(layer.spec):
            _promote_tails(c, x.dtype)
        x = decode_layer(cfg, layer, x, layer_cache(c, rep), pos, impl)
    cache["pos"] = pos + 1
    x = norm_apply(params.final_norm, x)
    return logits(cfg, params, x), cache


@torch.no_grad()
def prefill(cfg, params: LM, tokens: Optional[torch.Tensor],
            extra_embeds: Optional[torch.Tensor] = None, max_len: int = 0,
            impl: Optional[str] = None, cache_dtype=torch.bfloat16):
    """Full-sequence forward that also fills a decode cache of ``max_len``
    positions (default S) in ``cache_dtype``. Returns (last-position logits
    (B, V), cache). Mamba cache leaves follow the reference's rule: a leaf
    is cast to ``cache_dtype`` only if it is not f32, so the f32 SSM state,
    and the conv tails of an f32 model, stay f32."""
    x = _embed_inputs(params, tokens, extra_embeds)
    B, S, _ = x.shape
    entry = sharding.token_seq_entry()
    if entry is not None:                 # the rank's block of the tokens
        S *= sharding.block_index(entry, sharding.installed()[1])[1]
    max_len = max_len or S
    positions = positions_of(x)
    schedule = build_schedule(cfg)
    cache = _new_cache(cfg, B, max_len, cache_dtype, x.device,
                       with_mamba=False, mesh=x.device_mesh
                       if sharding.is_dtensor(x) else None)
    cache["pos"] = S
    for si, rep, bpos, layer in params.all_layers():
        x = prefill_layer(cfg, layer, x, positions, impl,
                          cache["segments"][si][bpos], rep,
                          schedule[si].count, cache_dtype)
    _, norm_apply = make_norm(cfg)
    x = norm_apply(params.final_norm, x)
    return logits(cfg, params, collectives.seq_tail(x, 1)[:, 0]), cache
