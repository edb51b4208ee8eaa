"""Checkpointing with manifest and atomic commit, as the reference's
``checkpoint/ckpt.py``, for a tree of tensors (nested dicts, lists, tuples
and dataclasses such as ``AdamWState``).

Layout:  <dir>/step_<n>/
            manifest.json       — leaf names, shapes, dtypes, step
            shard_<h>.npz       — this host's leaves
            COMMIT              — written last; restore ignores dirs without it

The training entry point checkpoints every ``every`` steps; after a crash it
restarts from the latest committed step, and the deterministic data
pipeline resumes from the stored step, so the sample stream is replayed
exactly. Leaves are saved whole and restored onto the device of the
matching leaf of ``like`` (or ``device``). bfloat16 leaves are stored as
their raw 16 bits (numpy has no bfloat16) and restored bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


def _children(tree: Tree) -> Optional[List[Tuple[str, Any]]]:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _flatten_with_names(tree: Tree, prefix: str = ""
                        ) -> List[Tuple[str, torch.Tensor]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, sub in kids:
        out += _flatten_with_names(sub, f"{prefix}/{name}" if prefix
                                   else name)
    return out


def _unflatten(like: Tree, leaves: List[Any]) -> Tree:
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(t):
        kids = _children(t)
        if kids is None:
            return next(it)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return dataclasses.replace(t, **{k: build(v) for k, v in kids})
    return build(like)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree: Tree,
                    host_index: int = 0) -> str:
    """Atomic per-step save (write to tmp, rename, then COMMIT)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = _flatten_with_names(tree)
    arrays = {name: _to_numpy(leaf) for name, leaf in leaves}
    np.savez(os.path.join(tmp, f"shard_{host_index}.npz"), **arrays)
    manifest = {
        "step": step,
        "leaves": {name: {"shape": list(leaf.shape),
                          "dtype": str(leaf.dtype).replace("torch.", "")}
                   for name, leaf in leaves},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(final, "COMMIT"), "w") as f:
        f.write("ok")
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and \
                os.path.exists(os.path.join(directory, d, "COMMIT")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Tree, step: Optional[int] = None,
                       host_index: int = 0, device=None) -> Tuple[Tree, int]:
    """Restore into the structure of ``like``: each leaf takes the dtype of
    ``like``'s leaf and lands on its device, or on ``device`` when given."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    data = np.load(os.path.join(path, f"shard_{host_index}.npz"))
    restored = []
    for name, proto in _flatten_with_names(like):
        if name not in manifest:
            raise KeyError(f"checkpoint {path} has no leaf {name}")
        t = torch.from_numpy(data[name])
        if manifest[name]["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        dev = device if device is not None else proto.device
        restored.append(t.to(device=dev, dtype=proto.dtype))
    return _unflatten(like, restored), step


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    every: int = 50
    keep: int = 3

    def maybe_save(self, step: int, tree: Tree) -> Optional[str]:
        if step % self.every != 0:
            return None
        path = save_checkpoint(self.directory, step, tree)
        self._gc()
        return path

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
