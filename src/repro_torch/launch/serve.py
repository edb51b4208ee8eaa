"""Serving entry point: Meili-planned replicated decode pipelines.

Plans per-segment replication with Algorithm 1 (from measured per-segment
decode latencies), builds N pipeline instances, and serves a batch of
requests with flow-sticky admission.

Usage (on the card; ``--device cpu`` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --requests 16 --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch moonshot-v1-16b-a3b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-1.5-large-398b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llava-next-34b --reduced --device cpu

qwen2.5-32b, minicpm-2b and llava-next-34b serve through the same path;
seamless-m4t-medium (encdec) raises ``KeyError('segments')``, as the
reference's ``launch.serve`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import Model, build
from repro_torch.models import lm as lm_mod
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.planner import (ServingPlan, plan_serving,
                                         segment_stage_names)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decode_body_fn(cfg):
    """One repetition of a segment's body for one decode step:
    ``fn(layers, caches, x, pos) -> x``, caches one layer-cache slice per
    body position (``lm.layer_cache``: k/v, or conv tails and SSM state),
    written in place."""
    def fn(layers, caches, x, pos):
        h = x
        for layer, c in zip(layers, caches):
            h = lm_mod.decode_layer(cfg, layer, h, c, pos, impl=None)
        return h
    return fn


@torch.no_grad()
def measure_segment_latencies(model, params, batch: int,
                              max_len: int) -> Dict[str, float]:
    """Wall-clock one decode pass per segment (one repetition timed three
    times, scaled by the repetition count), synchronized around the timing
    when on the card. The pass carries activations in the parameters'
    dtype, as a decode step's embedding lookup gives them (the reference
    passes f32 zeros, which JAX promotes against bf16 weights; PyTorch
    does not mix the two in a product). An encoder-decoder has no layer
    segments to plan over: it raises ``KeyError('segments')``, as the
    reference's ``launch.serve`` does (it reads ``params["segments"]``);
    the reference serves no encdec model, and neither does the port."""
    cfg = model.cfg
    if cfg.family == "encdec":
        raise KeyError("segments", f"{cfg.name}: launch.serve plans over "
                       "a decoder LM's layer segments; an "
                       "encoder-decoder has none (the reference's "
                       "launch.serve raises the same KeyError)")
    dev = model.device
    dtype = params.embed["table"].dtype
    cache = model.init_cache(batch, max_len, torch.float32)
    names = segment_stage_names(cfg)
    fn = _decode_body_fn(cfg)
    lat = {}
    for i, seg in enumerate(lm_mod.build_schedule(cfg)):
        layers = params.layers(i, 0)
        cs = [lm_mod.layer_cache(c, 0) for c in cache["segments"][i]]
        x = torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev)
        fn(layers, cs, x, 1)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            fn(layers, cs, x, 1)
        _sync(dev)
        lat[names[i]] = (time.perf_counter() - t0) / 3 * seg.count
    return lat


def make_requests(cfg, n: int, tokens: int) -> List[Request]:
    """The requests ``run`` serves: 4-token prompts drawn from numpy's
    ``default_rng(0)``, as the reference draws them."""
    rng = np.random.default_rng(0)
    return [Request(rid=rid, prompt=rng.integers(2, cfg.vocab, size=4)
                    .tolist(), max_new_tokens=tokens) for rid in range(n)]


@dataclasses.dataclass
class ServeReport:
    plan: ServingPlan
    done: List[Request]
    requests: int
    seconds: float
    model: Model           # what served: the model, its parameters and
    params: lm_mod.LM      # the engine with its instances' caches
    engine: ServingEngine

    @property
    def tokens(self) -> int:
        return sum(len(r.out) for r in self.done)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.seconds


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(argv=None) -> ServeReport:
    """Plan, build and serve as ``main`` does; returns what was served."""
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced().replace(remat=False)
    model = build(cfg, args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0),
                        torch.float32)

    lat = measure_segment_latencies(model, params, args.slots, args.max_len)
    plan = plan_serving(model, lat)
    print("[serve] Meili plan:")
    print(plan.summary())

    engine = ServingEngine(model, params, num_pipelines=plan.num_pipelines,
                           slots_per_pipeline=args.slots,
                           max_len=args.max_len)
    _sync(model.device)
    t0 = time.perf_counter()
    for req in make_requests(cfg, args.requests, args.tokens):
        engine.submit(req)
    done = engine.run(max_steps=args.max_len - 8)
    _sync(model.device)
    report = ServeReport(plan=plan, done=done, requests=args.requests,
                         seconds=time.perf_counter() - t0, model=model,
                         params=params, engine=engine)
    print(f"[serve] {len(done)}/{args.requests} requests, "
          f"{report.tokens} tokens in {report.seconds:.1f}s "
          f"({report.tokens_per_s:.1f} tok/s across "
          f"{plan.num_pipelines} pipelines)")
    return report


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
