"""One run of a cell: set-up, the checked steps, the measured window, and
the reference's two steps after it.

``Program`` builds the program's training step once (its model, the
benchmark's seeded weights, AdamW state) and drives it: the two
checked steps of set-up, the first of them the warm-up, and then the
window, which continues the same object on the next batches. The
reference (``reference_readings``) runs after the window, once the
program's state is freed, from the same seeded weights on the same first
two batches, and ``check.numbers`` compares the two sides' readings.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pbench import check, spec, tracing, traffic, weights
from pbench.reference import common

# two, not three: at the window's 10 s the reference's three steps took
# longer than the window (a reference step costs about a program step)
CHECKED_STEPS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """Of ``names`` (default: the loaded modules), the top-level names that
    are JAX's or the JAX package's, compared whole (``repro_torch`` is
    not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def accum_for(model_cfg: Dict, rows: int) -> int:
    """The microbatch count: the largest m <= the configuration's
    ``microbatch`` that divides the rows."""
    for m in range(min(model_cfg["microbatch"], rows), 0, -1):
        if rows % m == 0:
            return m
    return 1


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def arch_of(cell: spec.Cell, arch=None):
    """The program's ArchConfig for the cell, run as the configuration
    file states: each of its keys that is a field of the ArchConfig is set
    to the file's value, and each that the ArchConfig derives (``d_inner``,
    ``ssm_heads``, ``head_dim``) must agree."""
    from repro_torch.configs import get_arch
    arch = arch or get_arch(cell.config["arch"])
    model = cell.config["model"]
    fields = {f.name for f in dataclasses.fields(arch)}
    arch = arch.replace(**{k: v for k, v in model.items() if k in fields})
    for key, want in model.items():
        if hasattr(arch, key) and getattr(arch, key) != want:
            raise ValueError(f"{cell.name}: the program's {key} is "
                             f"{getattr(arch, key)!r}, the configuration "
                             f"states {want!r}")
    return arch


class Program:
    """The program's training step with its model, parameters and AdamW
    state, built once from ``seed``. ``impl="torch"`` takes the program's
    plain path instead of its kernels (a witness, never timed)."""

    def __init__(self, cell: spec.Cell, seed: int, device, arch=None,
                 impl: Optional[str] = None):
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import build
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.cfg = cell.config["model"]
        self.leaves = spec.family_module(
            "reference", cell.config["family"]).leaves(self.cfg)
        self.model = build(arch_of(cell, arch), self.device)
        params = self.model.param_struct(torch.float32)
        have = {n: tuple(p.shape) for n, p in params.named_parameters()}
        if have != dict(self.leaves):
            raise ValueError(f"{cell.name}: the program's parameters differ "
                             f"from the configuration's: "
                             f"{sorted(set(have.items()) ^ set(self.leaves))[:6]}")
        for name, t in weights.make(self.leaves, seed, self.device).items():
            path, _, leaf = name.rpartition(".")
            params.get_submodule(path).register_parameter(
                leaf, torch.nn.Parameter(t, requires_grad=True))
        self.params = params
        mix = cell.traffic
        sch = cell.config["assumed"]["schedule"]
        self.step_fn, opt_init = make_train_step(
            self.model, ShapeConfig(cell.name, mix["seq_len"], mix["rows"],
                                    "train"),
            base_lr=sch["base_lr"], warmup=sch["warmup"],
            total_steps=sch["total_steps"], impl=impl)
        if self.step_fn.accum != accum_for(self.cfg, mix["rows"]):
            raise ValueError(f"{cell.name}: the program splits a step into "
                             f"{self.step_fn.accum} microbatches, the "
                             f"configuration into "
                             f"{accum_for(self.cfg, mix['rows'])}")
        self.opt_state = opt_init(self.params)
        self.batches = traffic.batches(mix, self.cfg["vocab"], seed)
        self.step = sch["first_step"]
        self.done = 0
        self.undo = []          # what a planted fault restores

    def named(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.params.named_parameters()}

    def run_step(self) -> Tuple[float, torch.Tensor]:
        """One step on the next batch, fed from the host as the training
        driver feeds it; the loss read back."""
        with record_function(tracing.STEP):
            batch = self.batches[self.done % len(self.batches)]
            tokens = torch.from_numpy(batch).to(self.device)
            self.params, self.opt_state, loss, gnorm = self.step_fn(
                self.params, self.opt_state, {"tokens": tokens}, self.step)
            value = float(loss)
        self.done += 1
        self.step += 1
        return value, gnorm

    def checked_steps(self) -> check.Readings:
        """The first steps, and the program's readings of them."""
        b1 = self.cell.config["assumed"]["adamw"]["b1"]
        r = check.Readings()
        for k in range(CHECKED_STEPS):
            loss, gnorm = self.run_step()
            r.losses.append(loss)
            r.gnorms.append(float(gnorm))
            if k == 0:
                mu = self.opt_state.mu
                r.grad_norms = check.leaf_norms(mu, 1 - b1)
                r.grad_probes = check.probe_products(mu, self.seed, 1 - b1)
        start = weights.make(self.leaves, self.seed, self.device)
        r.change_norms = check.change_norms(self.named(), start)
        del start
        return r

    def window(self, seconds: float, trace: bool) -> Dict:
        """Whole steps until ``seconds`` have passed, ending with a
        synchronize: steps, failed steps, seconds, each step's seconds, the
        peak bytes, launch counts, and with ``trace`` the
        ``tracing.Trace``."""
        from repro_torch.kernels import _build
        prof = None
        if trace:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
        _build.reset_launch_counts()
        failed = 0
        ends = []
        sync(self.device)
        t0 = time.perf_counter()
        with record_function(tracing.WINDOW):
            while True:
                loss, _ = self.run_step()
                ends.append(time.perf_counter())
                failed += not math.isfinite(loss)
                if ends[-1] - t0 >= seconds:
                    break
            sync(self.device)
        t1 = time.perf_counter()
        out = {"steps": len(ends), "failed": failed, "seconds": t1 - t0,
               "step_s": [b - a for a, b in zip([t0] + ends, ends)],
               "peak_bytes": peak_bytes(self.device),
               "launches": _build.launch_counts(), "trace": None}
        if prof is not None:
            prof.__exit__(None, None, None)
            out["trace"] = tracing.from_profiler(prof)
        return out

    def free(self) -> None:
        while self.undo:
            self.undo.pop()()
        del self.params, self.opt_state, self.step_fn, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(cell: spec.Cell, seed: int, device,
                       precision: str = "f32") -> check.Readings:
    """The reference's checked steps from the seeded weights on the first
    batches, in ``precision``, and its readings."""
    device = torch.device(device)
    cfg, mix = cell.config["model"], cell.traffic
    assumed = cell.config["assumed"]
    fam = spec.family_module("reference", cell.config["family"])
    leaves = fam.leaves(cfg)
    prod = common.Products(precision, device)
    batches = [torch.from_numpy(b).to(device) for b in
               traffic.batches(mix, cfg["vocab"], seed)[:CHECKED_STEPS]]
    sch, b1 = assumed["schedule"], assumed["adamw"]["b1"]
    lrs = [common.lr_at(sch, sch["first_step"] + k)
           for k in range(CHECKED_STEPS)]
    r = check.Readings()

    def on_step(k, loss, gnorm, m):
        r.losses.append(loss)
        r.gnorms.append(gnorm)
        if k == 0:
            r.grad_norms = check.leaf_norms(m, 1 - b1)
            r.grad_probes = check.probe_products(m, seed, 1 - b1)

    params = weights.make(leaves, seed, device)
    with common.matmul_precision(precision):
        params = common.train_steps(
            lambda P, mb: fam.loss(cfg, P, mb, prod), params, batches,
            accum_for(cfg, mix["rows"]), lrs, assumed["adamw"], on_step)
    r.change_norms = check.change_norms(params,
                                        weights.make(leaves, seed, device))
    return r


class LayerContext:
    """What a per-layer reader reads: the cell, the traced window and the
    program's launch counts over it, and the family's counts."""

    def __init__(self, cell: spec.Cell, win: Dict):
        self.cell = cell
        self.cfg = cell.config["model"]
        self.mix = cell.traffic
        self.trace: tracing.Trace = win["trace"]
        self.launches: Dict[str, int] = win["launches"]
        self.steps = self.trace.steps
        self.accum = accum_for(self.cfg, self.mix["rows"])
        self.counts = spec.family_module("counts", cell.config["family"])

    def step_flops(self) -> float:
        return sum(self.counts.step_flops(self.cfg, self.mix["rows"],
                                          self.mix["seq_len"]).values())

    def launch_bounds(self) -> Dict[str, float]:
        return self.counts.launch_bounds(
            self.cfg, self.mix["rows"] // self.accum, self.mix["seq_len"])

    def roofline(self, launch_names, patterns) -> Optional[float]:
        """Σ bound ÷ Σ device time, in %, over the window's launches of
        ``launch_names`` and the device time of kernels matching
        ``patterns``; None where there is neither."""
        bounds = self.launch_bounds()
        bound = sum(self.launches.get(n, 0) * bounds[n]
                    for n in launch_names if n in bounds)
        busy = self.trace.device_seconds(patterns)
        if bound <= 0 or busy <= 0:
            return None
        return 100.0 * bound / busy


def end_to_end(cell: spec.Cell, win: Dict, setup_s: float
               ) -> Dict[str, Dict]:
    """The cell's end-to-end metrics, each the value of its quantity: the
    tokens of the window's steps over the window, the window's peak
    allocation in 10^9 bytes, and the set-up's seconds."""
    value = {"train_tokens_per_s": win["steps"]
             * traffic.tokens_per_step(cell.traffic) / win["seconds"],
             "train_peak_gb": win["peak_bytes"] / 1e9,
             "setup_s": setup_s}
    return {m["name"]: {"value": value[spec.quantity(m["name"])],
                        "unit": m["unit"]} for m in cell.end_to_end}


def per_layer(cell: spec.Cell, win: Dict) -> Dict[str, Dict]:
    ctx = LayerContext(cell, win)
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def plant_half_batch(prog: Program) -> None:
    """A fault in the program: each microbatch's loss (and so its
    gradient) over its first half of rows, or of positions for one row;
    the mean taken over the rest."""
    whole = prog.model.loss

    def half(params, batch, impl=None):
        t = batch["tokens"]
        t = t[:t.shape[0] // 2] if t.shape[0] > 1 else t[:, :t.shape[1] // 2]
        return whole(params, {"tokens": t}, impl=impl)
    prog.model.loss = half


def plant_state_dropped(prog: Program, chunk: Optional[int] = None) -> None:
    """A fault in the program: its SSD restarts every chunk of ``chunk``
    steps (the configuration's ``ssd_chunk``) from a zero state, the state
    passed between chunks dropped; each chunk goes to the program's own
    SSD as a sequence of its own. Undone by ``prog.free``."""
    from repro_torch.kernels import ops
    whole = ops.ssd
    T = chunk or prog.cfg["ssd_chunk"]

    def dropped(x, a, b, c, **kw):
        B, S = x.shape[:2]
        n = S // min(T, S)
        fold = lambda t: t.reshape(B * n, S // n, *t.shape[2:])
        y, h = whole(fold(x), fold(a), fold(b), fold(c), **kw)
        return y.reshape(x.shape), h
    ops.ssd = dropped
    prog.undo.append(lambda: setattr(ops, "ssd", whole))


def plant_unchanged_state(prog: Program) -> None:
    """A fault in the program: a step that computes its loss and returns
    its parameters and optimizer state unchanged."""
    step = prog.step_fn

    def unchanged(params, opt_state, batch, i):
        keep = {n: p.detach().clone() for n, p in params.named_parameters()}
        mu = {n: t.clone() for n, t in opt_state.mu.items()}
        nu = {n: t.clone() for n, t in opt_state.nu.items()}
        count = opt_state.count.clone()
        params, opt_state, loss, gnorm = step(params, opt_state, batch, i)
        with torch.no_grad():
            for n, p in params.named_parameters():
                p.copy_(keep[n])
            for n in mu:
                opt_state.mu[n].copy_(mu[n])
                opt_state.nu[n].copy_(nu[n])
            opt_state.count = count
        return params, opt_state, loss, gnorm
    unchanged.accum = step.accum
    prog.step_fn = unchanged
