"""State carried across from the JAX package, and outputs carried back.

The data plane's "weights" are its data and state: packet batches, the
flow cache's planes and epoch, and each accelerator stage's constants (DFA
table, out_count, keys). The LM's are its parameter tree and decode cache
(KV rows, or a mamba layer's conv tails and SSM state), and in training its
AdamW state.
Everything crosses as numpy arrays: take ``np.asarray`` of the JAX
package's arrays, hand them to the loaders here, and compare the port's
outputs through ``batch_to_numpy`` / ``leaves_to_numpy``, which list leaves
in the reference's order (fields in declaration order, ``meta`` keys sorted
— ``jax.tree.leaves``'s order), or ``lm_cache_to_numpy`` and
``encdec_cache_to_numpy``, which rebuild the reference's cache trees.
bfloat16 arrays cross as float32 (numpy has no bfloat16 of its own); the
widening is exact.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.flowcache import FlowCache
from repro_torch.core.graph import MeiliApp, PacketBatch, tree_leaves
from repro_torch.hw import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.optim import AdamWState

_FIELDS = ("payload", "length", "five_tuple", "mask")


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def packet_batch(payload: np.ndarray, length: np.ndarray,
                 five_tuple: np.ndarray, mask: Optional[np.ndarray] = None,
                 meta: Optional[Mapping[str, np.ndarray]] = None,
                 device="cuda") -> PacketBatch:
    """A PacketBatch from numpy arrays, dtypes pinned as ``make_packets``
    pins them (meta arrays keep their own dtypes)."""
    dev = resolve_device(device)
    payload = np.asarray(payload, np.uint8)
    if mask is None:
        mask = np.ones(payload.shape[0], bool)
    return PacketBatch(
        payload=_tensor(payload, dev),
        length=_tensor(np.asarray(length, np.int32), dev),
        five_tuple=_tensor(np.asarray(five_tuple, np.int32), dev),
        mask=_tensor(np.asarray(mask, bool), dev),
        meta={k: _tensor(np.asarray(v), dev)
              for k, v in sorted((meta or {}).items())})


def batch_to_numpy(batch: PacketBatch) -> Dict[str, np.ndarray]:
    """Leaves as numpy, keyed ``payload``, ``length``, ``five_tuple``,
    ``mask``, then ``meta.<key>`` in sorted key order."""
    out = {f: getattr(batch, f).cpu().numpy() for f in _FIELDS}
    for k in sorted(batch.meta):
        out[f"meta.{k}"] = batch.meta[k].cpu().numpy()
    return out


def leaves_to_numpy(tree: Any) -> List[np.ndarray]:
    """Every leaf as numpy, in the reference's leaf order."""
    return [t.cpu().numpy() for t in tree_leaves(tree)]


# -- flow cache ------------------------------------------------------------------

_CACHE_PLANES = ("key_lo", "key_hi", "pid", "ep", "stamp", "ref")


def flow_cache_state(cache: Any) -> Dict[str, Any]:
    """Host planes, epoch and stats of a flow cache (either package's:
    both keep the same numpy attributes)."""
    state = {k: np.array(getattr(cache, k), copy=True) for k in _CACHE_PLANES}
    state["epoch"] = int(cache.epoch)
    state["stats"] = dict(cache.stats)
    return state


def load_flow_cache(cache: FlowCache, state: Mapping[str, Any]) -> FlowCache:
    """Overwrite a port cache's host planes and epoch (and stats when given)
    with ``state``; the device mirror is re-uploaded at the next lookup."""
    for k in _CACHE_PLANES:
        if k in state:
            cur = getattr(cache, k)
            arr = np.asarray(state[k], dtype=cur.dtype)
            if arr.shape != cur.shape:
                raise ValueError(f"flow cache plane {k}: shape {arr.shape} "
                                 f"!= {cur.shape}")
            cur[...] = arr
    cache.epoch = int(state["epoch"])
    if "stats" in state:
        cache.stats.update(state["stats"])
    cache._full_upload = True
    return cache


# -- accelerator constants ---------------------------------------------------------

def accel_state(app: MeiliApp) -> Dict[str, Dict[str, np.ndarray]]:
    """Constants of every accelerator stage that has them, by stage name:
    ``table``/``out_count`` for regex stages, ``key`` for AES and sha."""
    return {fn.name: {k: v.copy() for k, v in fn.ucf.consts.arrays.items()}
            for fn in app.stages if hasattr(fn.ucf, "consts")}


def load_accel_state(app: MeiliApp,
                     state: Mapping[str, Mapping[str, np.ndarray]]) -> MeiliApp:
    """Overwrite accelerator constants by stage name (dtypes pinned: int32
    tables, uint32 keys)."""
    by_name = {fn.name: fn for fn in app.stages}
    for name, arrays in state.items():
        consts = by_name[name].ucf.consts
        pinned = {k: np.asarray(v, consts.arrays[k].dtype)
                  for k, v in arrays.items()}
        consts.set(**pinned)
    return app


# -- LM parameters and KV cache -----------------------------------------------------

def _lm_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return _tensor(a, device)


def _map_tree(tree: Any, fn) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_jax(cfg, params: Mapping, device="cuda") -> lm_mod.LM:
    """The port's LM holding the JAX package's LM parameters (dense or
    ssm family).

    ``params`` is the tree of ``repro.models.lm.init_lm`` with numpy leaves.
    Each segment's leaves are stacked over its repetitions on axis 0; they
    are unstacked into one ``DecoderLayer`` per (repetition, body
    position), repetition-major, whatever the leaf: a projection, a norm
    scale, or a mamba layer's bare ``A_log``/``dt_bias``/``D_skip`` (H,)
    and conv weights. Projections keep their stored layouts, (D, H, dh)
    for q/k/v and (H, dh, D) for o."""
    dev = resolve_device(device)
    to_t = lambda a: _lm_tensor(a, dev)
    segments = []
    for seg, seg_p in zip(lm_mod.build_schedule(cfg), params["segments"]):
        layers = []
        for rep in range(seg.count):
            for bpos in range(len(seg.body)):
                layers.append(_map_tree(seg_p[bpos],
                                        lambda a: to_t(np.asarray(a)[rep])))
        segments.append(layers)
    head = _map_tree(params["head"], to_t) if "head" in params else None
    return lm_mod.LM(cfg, _map_tree(params["embed"], to_t), segments,
                     _map_tree(params.get("final_norm", {}), to_t), head)


def encdec_params_from_jax(cfg, params: Mapping, device="cuda"
                           ) -> encdec_mod.EncDec:
    """The port's EncDec holding the JAX package's encoder-decoder
    parameters (the tree of ``repro.models.encdec.init_encdec``, numpy
    leaves). The ``enc`` and ``dec`` stacks carry a leading layer axis;
    they are unstacked into one layer module per layer, in order."""
    dev = resolve_device(device)
    to_t = lambda a: _lm_tensor(a, dev)

    def unstack(stack, n):
        return [_map_tree(stack, lambda a, i=i: to_t(np.asarray(a)[i]))
                for i in range(n)]
    return encdec_mod.EncDec(
        cfg, _map_tree(params["embed"], to_t),
        unstack(params["enc"], cfg.enc_layers),
        unstack(params["dec"], cfg.dec_layers),
        _map_tree(params.get("enc_norm", {}), to_t),
        _map_tree(params.get("dec_norm", {}), to_t))


def lm_named_from_jax(cfg, tree: Mapping, device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """A tree shaped as the JAX package's model parameters (the
    parameters, a gradient, an AdamW moment; numpy leaves; an LM's or,
    for the encdec family, an encoder-decoder's) as the port's flat
    mapping from parameter name (``named_parameters()``) to tensor."""
    load = (encdec_params_from_jax if cfg.family == "encdec"
            else lm_params_from_jax)
    return {k: p.detach() for k, p in
            load(cfg, tree, device).named_parameters()}


def adamw_state_from_jax(cfg, state: Any, device="cuda") -> AdamWState:
    """The port's AdamW state from the reference's ``AdamWState`` (mu and
    nu trees shaped as the parameters, count; numpy leaves): the moments
    keyed by the port's parameter names, each in its own dtype."""
    dev = resolve_device(device)
    return AdamWState(mu=lm_named_from_jax(cfg, state.mu, dev),
                      nu=lm_named_from_jax(cfg, state.nu, dev),
                      count=torch.tensor(int(np.asarray(state.count)),
                                         dtype=torch.int32, device=dev))


def lm_cache_from_jax(cache: Mapping, device="cuda") -> Dict[str, Any]:
    """A port cache from the JAX package's cache tree (numpy leaves), leaf
    by leaf with each leaf's dtype kept (a mamba layer's f32 state next to
    bf16 conv tails)."""
    dev = resolve_device(device)
    return {"pos": int(np.asarray(cache["pos"])),
            "segments": [[_map_tree(c, lambda a: _lm_tensor(a, dev))
                          for c in seg] for seg in cache["segments"]]}


def lm_cache_to_numpy(cache: Mapping) -> Dict[str, Any]:
    """The port's cache as the reference's tree: ``pos`` an int32 scalar,
    each leaf stacked over repetitions as a numpy array — k/v (count, B,
    max_len, Hkv, dh), or a mamba layer's conv tails and f32 state h
    (count, B, H, N, P) — bfloat16 leaves widened to float32."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {"pos": np.int32(cache["pos"]),
            "segments": [[_map_tree(c, leaf) for c in seg]
                         for seg in cache["segments"]]}


_ENCDEC_LEAVES = ("self_k", "self_v", "cross_k", "cross_v")


def encdec_cache_from_jax(cache: Mapping, device="cuda") -> Dict[str, Any]:
    """A port encoder-decoder cache from the JAX package's (numpy leaves),
    each leaf's dtype kept."""
    dev = resolve_device(device)
    out = {"pos": int(np.asarray(cache["pos"]))}
    out.update({k: _lm_tensor(cache[k], dev) for k in _ENCDEC_LEAVES})
    return out


def encdec_cache_to_numpy(cache: Mapping) -> Dict[str, Any]:
    """The port's encoder-decoder cache as the reference's tree: ``pos``
    an int32 scalar, each leaf (L, B, S, Hkv, dh) as numpy, bfloat16
    widened to float32."""
    out = {"pos": np.int32(cache["pos"])}
    for k in _ENCDEC_LEAVES:
        t = cache[k].detach().cpu()
        out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out
