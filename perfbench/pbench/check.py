"""The comparison that decides ``correct``.

Both sides, the program's timed step and the plain reference, run the
same first two steps from the same weights on the same batches, and
give the same readings (``Readings``): each step's loss and gradient norm
before clipping; per leaf, the norm of the first gradient as AdamW got
it, worked out from its first moment after one step (m / (1 - b1)), and
that gradient's product with a seeded Gaussian probe; per leaf, the norm
of the parameters' change after the two steps. Norms and products are
taken in f64.

The numbers compared (``numbers``), each with its limit in the cell's
workload file:

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the two first-gradient
  norms, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
* ``grad_probe_gap``: the same for the probe products (about the norm
  of the two gradients' difference, where ``grad_gap`` sees only their
  lengths);
* ``change_gap``: as ``grad_gap``, for the norms of the change, over the
  leaves whose reference gradient is at least 1e-3 of the median leaf's
  (a leaf below that moves by round-off alone);
* ``gnorm_gap``: the widest relative gap of a step's gradient norm.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Mapping

import torch

PROBE_SALT = 0x5EED_0F_9A0BE
QUIET_LEAF = 1e-3


@dataclasses.dataclass
class Readings:
    losses: List[float] = dataclasses.field(default_factory=list)
    gnorms: List[float] = dataclasses.field(default_factory=list)
    grad_norms: Dict[str, float] = dataclasses.field(default_factory=dict)
    grad_probes: Dict[str, float] = dataclasses.field(default_factory=dict)
    change_norms: Dict[str, float] = dataclasses.field(default_factory=dict)


@torch.no_grad()
def leaf_norms(tensors: Mapping[str, torch.Tensor], div: float = 1.0
               ) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t, dtype=torch.float64)) / div
            for n, t in tensors.items()}


@torch.no_grad()
def probe_products(tensors: Mapping[str, torch.Tensor], seed: int,
                   div: float = 1.0) -> Dict[str, float]:
    """<t, r> / div for each leaf t, r Gaussian, drawn leaf by leaf in name
    order from one generator seeded by ``seed``."""
    names = sorted(tensors)
    dev = tensors[names[0]].device
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed ^ PROBE_SALT) & (2**64 - 1))
    out = {}
    for n in names:
        t = tensors[n]
        r = torch.randn(t.shape, generator=gen, dtype=t.dtype, device=dev)
        out[n] = float(torch.sum(t.double() * r.double())) / div
        del r
    return out


@torch.no_grad()
def change_norms(params: Mapping[str, torch.Tensor],
                 start: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(p - start[n],
                                              dtype=torch.float64))
            for n, p in params.items()}


def _worst(got: Dict[str, float], want: Dict[str, float],
           scale: Dict[str, float], keep) -> float:
    names = [n for n in want if keep(n)]
    med = statistics.median(abs(scale[n]) for n in names)
    return _max([abs(got[n] - want[n]) / max(abs(scale[n]), med)
                 for n in names])


def _rel(got: List[float], want: List[float]) -> float:
    if len(got) != len(want):
        return math.nan
    return _max([abs(g - w) / abs(w) for g, w in zip(got, want)])


def _max(gaps: List[float]) -> float:
    """The largest gap; NaN where any is not finite (``max`` would skip a
    NaN)."""
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.nan


def numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    """Every number the comparison can hold (NaN where a side's reading is
    not finite, which no limit passes)."""
    med_g = statistics.median(ref.grad_norms.values())
    moving = lambda n: ref.grad_norms[n] >= QUIET_LEAF * med_g
    out = {
        "loss_gap": _rel(prog.losses, ref.losses),
        "gnorm_gap": _rel(prog.gnorms, ref.gnorms),
        "grad_gap": _worst(prog.grad_norms, ref.grad_norms, ref.grad_norms,
                           lambda n: True),
        "grad_probe_gap": _worst(prog.grad_probes, ref.grad_probes,
                                 ref.grad_norms, lambda n: True),
        "change_gap": _worst(prog.change_norms, ref.change_norms,
                             ref.change_norms, moving),
    }
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Each number held within its limit; NaN passes none."""
    return all(nums[k] <= lim for k, lim in limits.items())


def worst_leaves(prog: Readings, ref: Readings, k: int = 3
                 ) -> Dict[str, List]:
    """For each per-leaf number, its k worst leaves with their gaps."""
    med_g = statistics.median(ref.grad_norms.values())
    out = {}
    for key, got, want, scale in (
            ("grad_gap", prog.grad_norms, ref.grad_norms, ref.grad_norms),
            ("grad_probe_gap", prog.grad_probes, ref.grad_probes,
             ref.grad_norms),
            ("change_gap", prog.change_norms, ref.change_norms,
             ref.change_norms)):
        med = statistics.median(abs(v) for v in scale.values())
        gaps = sorted(((abs(got[n] - want[n]) / max(abs(scale[n]), med), n)
                       for n in want), reverse=True)[:k]
        out[key] = [[n, g] for g, n in gaps]
    out["median_grad_norm"] = med_g
    return out


def quiet_leaves(ref: Readings) -> List[str]:
    med_g = statistics.median(ref.grad_norms.values())
    return sorted(n for n, g in ref.grad_norms.items()
                  if g < QUIET_LEAF * med_g)
