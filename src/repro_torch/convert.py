"""State carried across from the JAX package, and outputs carried back.

The system runs no model, so its "weights" are its data and state: packet
batches, the flow cache's planes and epoch, and each accelerator stage's
constants (DFA table, out_count, keys). Everything crosses as numpy arrays:
take ``np.asarray`` of the JAX package's arrays, hand them to the loaders
here, and compare the port's outputs through ``batch_to_numpy`` /
``leaves_to_numpy``, which list leaves in the reference's order (fields in
declaration order, ``meta`` keys sorted — ``jax.tree.leaves``'s order).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.flowcache import FlowCache
from repro_torch.core.graph import MeiliApp, PacketBatch, tree_leaves
from repro_torch.hw import resolve_device

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
