"""Rank workers of the expert-parallel tests, and the one-process emulation
of the ranks of a mesh that is their oracle on the card.

No JAX here: the workers run in processes spawned from a test (gloo over
localhost, one process a rank) or from ``chip_smoke.py`` on the card.

* ``run_world(case, world, model, inputs, workdir)`` spawns ``world``
  ranks, each of which builds ``make_host_mesh(model)`` over the group,
  runs ``CASES[case](mesh, inputs, device)`` and pickles its result; the
  ranks are joined within a time limit and killed past it, and a rank's
  traceback is raised in the caller.
* ``emulate_ep`` computes the reference's ``_moe_ep`` for every rank of a
  (d, m) mesh in one process, without collectives: each rank's local
  dispatch, each expert shard's products on the slots of the ranks of its
  data row, each rank's combine.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import socket
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, moe
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh

ARCH = "moonshot-v1-16b-a3b"
RULES = {"dp_heavy": sh.dp_heavy_rules, "default": sh.default_rules}
GROUP_TIMEOUT_S = 90


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cfg_of(overrides: Dict[str, Any]):
    return get_arch(ARCH).reduced().replace(**overrides)


def run_world(case: str, world: int, model: int, inputs: Any, workdir: str,
              timeout: float = 120.0, device: str = "cpu",
              module: str = __name__) -> List[Any]:
    """Each rank's result of ``CASES[case]`` of ``module`` (this one by
    default) over a gloo world of ``world`` ranks on a (world // model,
    model) mesh."""
    in_path = os.path.join(workdir, f"{case}.{world}x{model}.in.pkl")
    for r in range(world):                 # no result of an earlier run
        for end in ("err", "out"):
            if os.path.exists(f"{in_path}.rank{r}.{end}"):
                os.remove(f"{in_path}.rank{r}.{end}")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, model, port, case, in_path, device,
                               module))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r, p in enumerate(procs):
        err = f"{in_path}.rank{r}.err"
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0 and r not in hung:
            errors.append(f"rank {r} exited {p.exitcode}")
    if errors or hung:
        raise RuntimeError(f"{case} over {world} ranks: "
                           + (f"ranks {hung} still running after {timeout} s; "
                              if hung else "") + "\n".join(errors))
    out = []
    for r in range(world):
        with open(f"{in_path}.rank{r}.out", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, world, model, port, case, in_path, device,
               module=__name__):
    import importlib
    import traceback
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        if device == "cuda":
            torch.cuda.set_device(0)
        mesh = make_host_mesh(model, device_type=device)
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        result = importlib.import_module(module).CASES[case](mesh, inputs,
                                                             device)
        with open(f"{in_path}.rank{rank}.out", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(f"{in_path}.rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        sh.set_activation_sharding(None, None)
        if dist.is_initialized():
            dist.destroy_process_group()


class _Spy:
    """While installed, counts ``moe._moe_ep`` calls and records the shape
    of every input of ``moe._expert_products``."""

    def __enter__(self):
        self.ep, self.products = 0, []
        self._ep, self._products = moe._moe_ep, moe._expert_products

        def ep(*a, **k):
            self.ep += 1
            return self._ep(*a, **k)

        def products(xe, *w):
            self.products.append(tuple(xe.shape))
            return self._products(xe, *w)
        moe._moe_ep, moe._expert_products = ep, products
        coll.reset_stats()
        return self

    def __exit__(self, *exc):
        moe._moe_ep, moe._expert_products = self._ep, self._products

    def report(self):
        return {"ep": self.ep, "products": self.products,
                "collectives": coll.stats()}


def tensors(p: Dict[str, np.ndarray], dtype: str, device) -> Dict:
    return {k: torch.from_numpy(v).to(device, getattr(torch, dtype))
            for k, v in p.items()}


def moe_case(mesh, inputs, device) -> Dict[str, Any]:
    """Each case's ``moe_ffn`` on this rank's block of its tokens, with the
    rules and the global (batch, seq) installed: the block, the token
    spec, and what the spy saw."""
    out = {"coords": sh.coordinates(mesh), "axes": sh.mesh_axes(mesh)}
    for c in inputs:
        cfg = cfg_of(c["cfg"])
        rules = RULES[c["rules"]]()
        p = tensors(c["params"], c["dtype"], device)
        x = torch.from_numpy(c["x"]).to(device, getattr(torch, c["dtype"]))
        spec = sh.token_spec(tuple(x.shape), rules, mesh)
        sh.set_activation_sharding(rules, mesh, tokens=tuple(x.shape[:2]))
        try:
            with torch.no_grad(), _Spy() as spy:
                y = moe.moe_ffn(p, sh.block(x, spec, mesh), cfg)
        finally:
            sh.set_activation_sharding(None, None)
        out[c["name"]] = {"y": y.float().cpu().numpy(), "spec": tuple(spec),
                          "dtype": str(y.dtype), **spy.report()}
    # activations that are not the installed tokens' block of this rank
    sh.set_activation_sharding(sh.dp_heavy_rules(), mesh, tokens=(4, 24))
    try:
        sh.global_shape(torch.zeros(3, 5, 8))
        out["mismatch"] = None
    except ValueError:
        out["mismatch"] = "ValueError"
    finally:
        sh.set_activation_sharding(None, None)
    return out


def prefill_case(mesh, inputs, device) -> Dict[str, Any]:
    """The reduced LM's prefill on this rank's block of the prompts, under
    the installed rules and tokens: its last-position logits."""
    cfg = cfg_of({})
    params = convert.lm_params_from_jax(cfg, inputs["params"], device=device)
    model = build(cfg, device)
    tokens = torch.from_numpy(inputs["tokens"]).to(device)
    rules = RULES[inputs["rules"]]()
    B, S = tokens.shape
    spec = sh.token_spec((B, S, 1), rules, mesh)
    sh.set_activation_sharding(rules, mesh, tokens=(B, S))
    try:
        with _Spy() as spy:
            lg, _ = model.prefill(params, {"tokens": sh.block(
                tokens, spec[:2], mesh)}, max_len=S)
    finally:
        sh.set_activation_sharding(None, None)
    return {"logits": lg.float().cpu().numpy(), "spec": tuple(spec),
            "coords": sh.coordinates(mesh), **spy.report()}


CASES = {"moe": moe_case, "prefill": prefill_case}


class Grid:
    """One rank of a (d, m) ("data", "model") grid, read by the sharding
    module's ``block`` and ``token_spec`` as a mesh is."""

    mesh_dim_names = ("data", "model")

    def __init__(self, d: int, m: int, rank=(0, 0)):
        self.sizes, self.rank = (d, m), tuple(rank)

    def size(self, i: int) -> int:
        return self.sizes[i]

    def get_coordinate(self):
        return list(self.rank)


def emulate_ep(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg, rules,
               d: int, m: int):
    """The reference's ``_moe_ep`` over a (d, m) mesh, one rank after the
    other in this process, for tokens x (B, S, D) whose layout splits them
    over both axes. Returns the output (B, S, D) and, for every rank, its
    slots' source tokens (``_dispatch_local``'s src) and its drops."""
    E, k, D = cfg.n_experts, cfg.top_k, x.shape[-1]
    El = E // m
    spec = sh.token_spec(tuple(x.shape), rules, Grid(d, m))
    ranks = [(i, j) for i in range(d) for j in range(m)]
    local = {}
    for r in ranks:
        xl = sh.block(x, spec, Grid(d, m, r))
        T = xl.shape[0] * xl.shape[1]
        local[r] = (xl, T) + moe._dispatch_local(xl.reshape(T, D),
                                                 p["router"], cfg)
    ye = {r: torch.empty_like(local[r][2]) for r in ranks}
    for i in range(d):
        for j in range(m):                 # expert shard j of data row i
            e = slice(j * El, (j + 1) * El)
            slots = torch.cat([local[(i, s)][2][e] for s in range(m)], 1)
            y = moe._expert_products(slots, p["gate"][e], p["up"][e],
                                     p["down"][e])
            C = local[(i, 0)][2].shape[1]
            for s in range(m):
                ye[(i, s)][e] = y[:, s * C:(s + 1) * C]
    out = torch.empty_like(x)
    src, drops = {}, {}
    for r in ranks:
        xl, T, _, s, gate_slot = local[r]
        y = moe._combine_local(ye[r].reshape(-1, D), s, gate_slot, T, D, k)
        sh.block(out, spec, Grid(d, m, r)).copy_(y.reshape(xl.shape))
        src[r] = s
        drops[r] = T * k - int((s > 0).sum())
    return out, src, drops
