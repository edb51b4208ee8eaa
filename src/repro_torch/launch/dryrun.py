"""Dry run of every (arch × shape) cell, as the reference's
``launch/dryrun.py``: what one step costs, without running it.

Mesh kinds:
  * ``card`` (default): the one H100 the port runs on. The whole step is
    traced on the meta device (``roofline.trace``; the attention and SSD
    kernels through their kernel-shaped branches), giving its FLOPs and
    bytes, the roofline built from them, its predicted peak memory and
    whether that fits the card. With ``--decompose`` the record also
    carries the per-piece view (``decompose.py``), whose totals equal the
    whole step's.
  * ``single`` / ``multi``: the reference's (16, 16) and (2, 16, 16)
    descriptions. Only what the resolver's specs give per device is
    recorded (``"analytic": true``): nothing partitions the port's trace.

Every kind records the parameter counts, tokens per step, the
accumulation count and the per-device bytes of the step's arguments
(parameters, AdamW state, batch, and the cache for decode). Parameters
and caches are bf16, as in the reference's dry run; AdamW's moments are
f32 (bf16 where the config says so). A decode step is traced at the
cache's last position (pos = S - 1).

The card's name and memory come from ``hw.device_spec`` (the data sheet
with ``--device cpu``, which runs the whole table on a machine without a
card).

Usage (``--arch`` and ``--shape`` take comma-separated lists; their
cells run, their skips are recorded):
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \
      --decompose --device cpu
  python -m repro_torch.launch.dryrun --all --device cpu --out build/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import hw
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import SHAPES, ShapeConfig, cells, skipped_cells
from repro_torch.launch import roofline as rl
from repro_torch.launch.decompose import decompose_cell
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import choose_microbatch, make_train_step
from repro_torch.models.registry import Model, build, cache_leaves
from repro_torch.parallel.sharding import (batch_dp_degree, mesh_axes,
                                           mesh_size, rules_for, spec_for,
                                           tree_specs)

MESH_KINDS = ("card", "single", "multi")
_INPUT_AXES = {"tokens": ("batch", "seq"), "patches": ("batch", "seq", None),
               "frames": ("batch", "seq", None)}


def mesh_for(kind: str):
    if kind == "card":
        return make_host_mesh()
    return make_production_mesh(multi_pod=kind == "multi")


def all_cells():
    """The (arch, shape) cells and the documented skips, in the
    reference's order."""
    run = [c for a in ARCHS for c in cells(a)]
    skip = [s for a in ARCHS for s in skipped_cells(a)]
    return run, skip


def step_call(model: Model, shape: ShapeConfig, dtype=torch.bfloat16,
              cache_dtype=torch.bfloat16, tokens_dtype=torch.int32,
              max_len: Optional[int] = None, **train_kw):
    """(fn, hold, extra): the step of ``shape`` on meta tensors, as a
    caller runs it, and the tensors that exist before it (its arguments).
    Training: ``make_train_step``'s step from AdamW's initial state (step
    1); prefill: ``model.prefill`` into a ``max_len`` cache (default S);
    decode: ``model.decode_step`` at pos = S - 1 of an S-deep cache."""
    meta = torch.device("meta")
    batch = {k: torch.empty(v.shape, dtype=tokens_dtype if k == "tokens"
                            else v.dtype, device=meta)
             for k, v in model.input_specs(shape, dtype).items()}
    if shape.kind == "train":
        params = model.param_struct(dtype).requires_grad_(True)
        step_fn, opt_init = make_train_step(model, shape, **train_kw)
        opt = opt_init(params)
        hold = (list(params.parameters()), opt.mu, opt.nu, opt.count, batch)
        return (lambda: step_fn(params, opt, batch, 1)), hold, \
            {"accum": step_fn.accum}
    params = model.param_struct(dtype)
    if shape.kind == "prefill":
        return (lambda: model.prefill(
            params, batch, max_len=max_len or shape.seq_len,
            cache_dtype=cache_dtype)), (list(params.parameters()), batch), {}
    cache = model.cache_struct(shape, cache_dtype)
    cache["pos"] = shape.seq_len - 1
    return (lambda: model.decode_step(params, cache, batch["tokens"])), \
        (list(params.parameters()), cache_leaves(cache), batch), {}


def _bytes(t: torch.Tensor, spec, sizes: Dict[str, int],
           dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of one device's shard of ``t`` under ``spec``."""
    split = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            split *= sizes[a]
    item = torch.empty((), dtype=dtype or t.dtype).element_size()
    return t.numel() * item // split


def argument_bytes(model: Model, shape: ShapeConfig, mesh, rules,
                   dtype=torch.bfloat16) -> Dict[str, int]:
    """Per-device bytes of the step's arguments under the resolver's
    specs: parameters, AdamW moments (train), batch, cache (decode)."""
    sizes = mesh_axes(mesh)
    params = dict(model.param_struct(dtype).named_parameters())
    specs = tree_specs(model.param_axes(), params, rules, mesh)
    out = {"params": sum(_bytes(t, specs[k], sizes)
                         for k, t in params.items())}
    if shape.kind == "train":
        st = torch.bfloat16 if model.cfg.bf16_optimizer_state else \
            torch.float32
        out["optimizer"] = 2 * sum(_bytes(t, specs[k], sizes, st)
                                   for k, t in params.items())
    batch = model.input_specs(shape, dtype)
    out["batch"] = sum(_bytes(t, spec_for(_INPUT_AXES[k][:t.dim()], t.shape,
                                          rules, mesh), sizes)
                       for k, t in batch.items())
    if shape.kind == "decode":
        cache = cache_leaves(model.cache_struct(shape, dtype))
        c_specs = tree_specs(model.cache_axes(), cache, rules, mesh)
        out["cache"] = sum(_bytes(t, c_specs[k], sizes)
                           for k, t in cache.items())
    out["total"] = sum(out.values())
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str = "card",
             device: str = "cuda", verbose: bool = True,
             decompose: bool = False) -> dict:
    """One cell's record; ``device`` names where the card's spec comes
    from (``"cpu"``: the data sheet). The card kind with ``"cuda"`` on a
    machine without a card raises, as every entry point does. With
    ``decompose`` the card kind also records the step's pieces
    (``decompose_cell``)."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    model = build(cfg, "meta")
    mesh = mesh_for(mesh_kind)
    chips = mesh_size(mesh)
    rules = rules_for(cfg, mesh)
    total, active = model.param_counts()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    dp = batch_dp_degree(rules, mesh, shape.global_batch)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": chips, "status": "ok", "params_total": total,
           "params_active": active, "tokens_per_step": tokens,
           "model_flops": rl.model_flops(total, active, shape.kind, tokens)}
    if shape.kind == "train":
        rec["accum"] = choose_microbatch(cfg, shape.global_batch, dp)
    t0 = time.perf_counter()
    args = argument_bytes(model, shape, mesh, rules)
    rec["memory"] = {"argument_size_bytes": args["total"],
                     "arguments": args}
    if mesh_kind != "card":
        rec["analytic"] = True
        rec["compile_s"] = time.perf_counter() - t0
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh_kind}: analytic, "
                  f"{args['total'] / 1e9:.2f} GB of arguments per device")
        return rec
    if hw.resolve_device(device).type == "cuda":
        spec = hw.device_spec(0)
    else:
        spec = hw.DeviceSpec("H100 SXM (data sheet)", hw.NUM_SMS,
                             hw.HBM_BYTES, hw.L2_BYTES)
    fn, hold, extra = step_call(model, shape)
    step = rl.trace(fn, hold=hold, memory=True)
    t_trace = step.pop("seconds")
    peak = step.pop("peak_bytes")
    rec.update(extra)
    rec["device"] = {"name": spec.name, "mem_bytes": spec.mem_bytes}
    rec["memory"].update({
        "held_bytes": step.pop("held_bytes"), "peak_bytes": peak,
        "temp_size_bytes": peak - args["total"],
        "fits": peak <= spec.mem_bytes})
    rec["compile_s"] = t_trace
    step.pop("bytes_by_op")
    rec["step"] = step
    rec["roofline"] = rl.build(step["flops"], step["bytes"],
                               rec["model_flops"]).to_dict()
    if decompose:
        t1 = time.perf_counter()
        dec = decompose_cell(model, shape)
        rec["decompose_s"] = time.perf_counter() - t1
        rec["pieces"] = {k: {kk: vv for kk, vv in v.items()
                             if kk != "bytes_by_op"}
                         for k, v in dec["pieces"].items()}
    if verbose:
        roof = rec["roofline"]
        print(f"[dryrun] {arch} × {shape_name} × card: OK (trace "
              f"{t_trace:.1f}s, dominant={roof['dominant']}, "
              f"roofline={roof['roofline_fraction']:.3f}, "
              f"useful={roof['useful_flops_ratio']:.3f}, peak "
              f"{peak / 1e9:.2f} GB, fits {rec['memory']['fits']})")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card",
                    choices=list(MESH_KINDS) + ["all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--missing", action="store_true",
                    help="run only cells without an ok record yet")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the card's spec comes from (cpu: the data "
                         "sheet)")
    ap.add_argument("--decompose", action="store_true",
                    help="also record each card cell's pieces")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    run, skip = all_cells()
    if not (args.all or args.missing):
        assert args.arch and args.shape, "--arch/--shape or --all"
        archs, shapes = args.arch.split(","), args.shape.split(",")
        for a in archs:
            get_arch(a)
        for s in shapes:
            SHAPES[s]
        run = [c for c in run if c[0] in archs and c[1] in shapes]
        skip = [c for c in skip if c[0] in archs and c[1] in shapes]
    meshes = list(MESH_KINDS) if args.mesh == "all" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in run:
        for mk in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mk}.json")
            if args.missing and os.path.exists(path):
                try:
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            continue
                except (OSError, ValueError):
                    pass
            try:
                rec = run_cell(arch, shape, mk, device=args.device,
                               decompose=args.decompose)
            except Exception as e:  # noqa: BLE001 — record and continue
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "status": "fail", "error": repr(e)}
                failures += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            sys.stdout.flush()
    for aa, ss, why in skip:
        with open(os.path.join(args.out, f"{aa}__{ss}__skip.json"),
                  "w") as f:
            json.dump({"arch": aa, "shape": ss, "status": "skipped",
                       "reason": why}, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
