#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Drives the port's main path — ``ParallelDataPlane.process`` with the flow
cache on — through the IPsec Gateway (all four NIC kernels: flow_lookup,
dfa_regex, keyed_hash, arx_cipher) and the Intrusion Detection app
(flow_lookup, dfa_regex) at full data size: 8 pipelines, 16,384-packet
batches of 1,500-byte packets over 10,000 flows, 4,096-slot rings per
pipeline, the 2^17-slot flow cache. Every batch's output is held bit for
bit against the port's ``run_pipeline`` with the plain PyTorch versions
(``impl="torch"``) on the same card, and each kernel is checked against its
plain version at the shapes the main path gave it and timed.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the kernels from ``src/repro_torch/kernels/csrc`` with nvcc
(into ``build/kernels/``), needs one CUDA device, and exits non-zero on any
failure. The last line of its output is ``{"ok": true, "device": {...}}``;
the line before it lists every kernel with its launches on the main path,
its error against the plain version, and its times beside its bound.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import hw  # noqa: E402
from repro_torch.apps import (intrusion_detection, ipsec_gateway,  # noqa: E402
                              synth_packets)
from repro_torch.apps.nf import SNORT_RULES  # noqa: E402
from repro_torch.core.executor import ParallelDataPlane, _bucket  # noqa: E402
from repro_torch.core.graph import bits, run_pipeline, tree_leaves  # noqa: E402
from repro_torch.core.orchestrator import flow_ids  # noqa: E402
from repro_torch.kernels import _build, crypto, dfa_regex, ref  # noqa: E402
from repro_torch.kernels import flow_lookup as fl  # noqa: E402

BATCH = 16384
FLOWS = 10_000
PKT_BYTES = 1500
PIPELINES = 8
CAPACITY = 4096          # packets per pipeline per round: 2x headroom
RING = 4096
N_BATCHES = 7            # seeds 0..6
WARMUP = 2               # the cold-cache batch and the first warm one
KERNEL_REPS = 20
PLAIN_REPS = 10
FLUSH_BYTES = 64 << 20   # > the 50 MB L2: each timed launch starts cold
SLEEP_CYCLES = 2_000_000  # ~1 ms of device time ahead of each timed call

REPLACES = {
    "flow_lookup": "src/repro/kernels/flow_lookup.py:142",
    "dfa_regex": "src/repro/kernels/dfa_regex.py:30",
    "arx_cipher": "src/repro/kernels/crypto.py:25",
    "keyed_hash": "src/repro/kernels/crypto.py:29",
}
SOURCES = {
    "flow_lookup": "src/repro_torch/kernels/csrc/flow_lookup.cu",
    "dfa_regex": "src/repro_torch/kernels/csrc/dfa_regex.cu",
    "arx_cipher": "src/repro_torch/kernels/csrc/crypto.cu",
    "keyed_hash": "src/repro_torch/kernels/csrc/crypto.cu",
}


class _Recorder:
    """Duck-typed metrics sink: keeps the data plane's histogram samples
    (``profile=True`` times each dispatch to completion)."""

    class _Series:
        def __init__(self, samples):
            self.samples = samples

        def observe(self, v):
            self.samples.append(v)

        def inc(self, v=1):
            pass

        def set(self, v):
            pass

    def __init__(self):
        self.samples = {}

    def histogram(self, name, **labels):
        return self._Series(self.samples.setdefault(name, []))

    counter = gauge = histogram


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _as_i64(t):
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def _max_abs_err(got, want) -> int:
    errs = [int((_as_i64(g) - _as_i64(w)).abs().max()) if g.numel() else 0
            for g, w in zip(got, want)]
    return max(errs)


def _time_ms(fn, reps, flush) -> float:
    """Median of ``reps`` calls, each timed alone with CUDA events after the
    L2 has been flushed. Each call is queued behind a ~1 ms device sleep,
    so the card is busy while the host launches it and the events see device
    time, not the wrapper's host-side launch overhead."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _assert_batches_equal(got, want, ctx):
    a, b = tree_leaves(got), tree_leaves(want)
    if len(a) != len(b):
        raise AssertionError(f"{ctx}: {len(a)} leaves != {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{ctx}: leaf {i} {x.dtype}{tuple(x.shape)}"
                                 f" != {y.dtype}{tuple(y.shape)}")
        if not torch.equal(bits(x), bits(y)):
            raise AssertionError(f"{ctx}: leaf {i} differs from the plain "
                                 f"run_pipeline")


def drive(name, factory, batches):
    """Main path of one app: counts reset just before, read just after."""

    rec = _Recorder()
    dp = ParallelDataPlane(factory(), num_pipelines=PIPELINES,
                           capacity_per_pipeline=CAPACITY, ring_capacity=RING,
                           metrics=rec, profile=True)
    outs, ms, hit_rates, Ms = [], [], [], []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for i, b in enumerate(batches):
        fs0 = dict(dp.to.fast_stats)
        t0 = time.perf_counter()
        outs.append(dp.process(b))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        hp = dp.to.fast_stats["hit_pkts"] - fs0["hit_pkts"]
        mp = dp.to.fast_stats["miss_pkts"] - fs0["miss_pkts"]
        hit_rates.append(hp / max(1, hp + mp))
        Ms.append(_bucket(int(max(p.load for p in dp.to.pipelines))))
        if i == WARMUP - 1:
            warm_compiles = dp.dispatch_stats["compiles"]
    launches = _build.launch_counts()
    if dp.dispatch_stats["compiles"] != warm_compiles:
        raise AssertionError(f"{name}: {dp.dispatch_stats['compiles']} "
                             f"dispatch shapes after warm-up, "
                             f"{warm_compiles} at its end")
    plain = factory(impl="torch")
    for i, (b, out) in enumerate(zip(batches, outs)):
        _assert_batches_equal(out, run_pipeline(plain, b), f"{name} batch {i}")
    steady = ms[WARMUP:]
    disp = rec.samples["dataplane_dispatch_us"][WARMUP:]
    stages = dp.profile_stages(batches[-1], iters=5)
    report = {
        "app": name, "batches": len(batches), "warmup": WARMUP,
        "batch_ms": [round(x, 3) for x in ms],
        "steady_ms_median": statistics.median(steady),
        "pkts_per_s": BATCH / (statistics.median(steady) / 1e3),
        "dispatch_ms_median": statistics.median(disp) / 1e3,
        "host_ms_median": statistics.median(steady)
        - statistics.median(disp) / 1e3,
        "hit_rate_pkts": [round(x, 4) for x in hit_rates],
        "lane_slots_M": Ms,
        "dispatch_compiles": dp.dispatch_stats["compiles"],
        "stage_us": {k: round(v, 1) for k, v in stages.items()},
        "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "equal_to_plain_run_pipeline": True,
    }
    return report, dp


def kernel_checks(dp, last_batch, launches_isg, launches_id):
    """Each kernel at the shapes the main path gave it, against its plain
    version on the same inputs, with its time beside its bound."""

    dev = last_batch.device
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    M = _bucket(int(max(p.load for p in dp.to.pipelines)))
    rows = PIPELINES * M                    # the chain runs over N*M lanes
    sel = torch.arange(rows, device=dev) % last_batch.batch
    payload = last_batch.payload[sel].contiguous()
    length = last_batch.length[sel].contiguous()
    table, out_count = ref.build_aho_corasick(SNORT_RULES)
    table = torch.from_numpy(table).to(dev)
    out_count = torch.from_numpy(out_count).to(dev)
    words = payload.view(torch.uint32)      # (rows, 375)
    key = torch.from_numpy(np.array([1, 2, 3, 4], np.uint32)).to(dev)

    cache = dp.to.flow_cache
    planes = cache._device_planes()
    uniq = np.unique(flow_ids(last_batch))
    F = 1 << (len(uniq) - 1).bit_length()
    lo, hi = fl.split_fids(np.concatenate([uniq, np.zeros(F - len(uniq),
                                                         np.int64)]))
    q_lo, q_hi = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
    ep = cache.epoch

    # data-dependent work of the probe: slots read until the first match
    cap, W = cache.capacity, cache.window
    base = fl.bucket_hash(lo, hi) & np.uint32(cap - 1)
    idx = ((base[:, None] + np.arange(W, dtype=np.uint32))
           & np.uint32(cap - 1)).astype(np.int64)
    match = ((cache.key_lo[idx] == lo[:, None])
             & (cache.key_hi[idx] == hi[:, None]) & (cache.pid[idx] >= 0))
    probes = np.where(match.any(1), match.argmax(1) + 1, W)
    touched = np.unique(np.concatenate(
        [idx[i, :probes[i]] for i in range(F)]))
    steps = int(length.clamp(0, PKT_BYTES).sum())
    S = table.shape[0]
    B, Wd = words.shape

    specs = {
        "flow_lookup": dict(
            run=lambda: fl.lookup_cuda(*planes, q_lo, q_hi, ep, W),
            plain=lambda: fl.lookup_torch(*planes, q_lo, q_hi, ep, W),
            shape=f"C={cap} F={F} W={W}",
            nbytes=F * 8 + F * 9 + touched.size * 16,
            ops=F * 12 + int(probes.sum()) * 5),
        "dfa_regex": dict(
            run=lambda: dfa_regex.dfa_regex_cuda(payload, length, table,
                                                 out_count),
            plain=lambda: dfa_regex.dfa_scan_torch(payload, length, table,
                                                   out_count),
            shape=f"B={rows} L={PKT_BYTES} S={S}",
            nbytes=steps + rows * 8 + S * 257 * 4, ops=steps * 4),
        "keyed_hash": dict(
            run=lambda: crypto.keyed_hash_cuda(words, key),
            plain=lambda: crypto.keyed_hash_torch(words, key),
            shape=f"B={B} W={Wd}", nbytes=B * Wd * 4 + B * 16 + 16,
            ops=B * Wd * 7),
        "arx_cipher": dict(
            run=lambda: crypto.arx_cipher_cuda(words, key),
            plain=lambda: crypto.arx_cipher_torch(words, key),
            shape=f"B={B} W={Wd}", nbytes=2 * B * Wd * 4 + 16,
            ops=B * Wd * 64),
    }
    kernels = []
    for name, s in specs.items():
        got, want = s["run"](), s["plain"]()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err = _max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {err}")
        bound_s, bound_by = hw.bound_seconds(s["nbytes"], s["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches_isg[name],
            "launches_by_path": {"ISG": launches_isg[name],
                                 "ID": launches_id[name]},
            "shape": s["shape"], "max_abs_err": err,
            "ms": _time_ms(s["run"], KERNEL_REPS, flush),
            "plain_ms": _time_ms(s["plain"], PLAIN_REPS, flush),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": int(s["nbytes"]), "ops": int(s["ops"]),
            "library_ms": None,
        })
    return kernels


def main() -> int:

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2

    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    spec = hw.device_spec(0)
    print(f"torch device: {kind}, {spec.sms} SMs, {spec.mem_bytes} B memory, "
          f"{spec.l2_bytes} B L2; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({len(_build.sources())} sources, sm_90a) -> "
          f"{_build.library_path().relative_to(ROOT)}")
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line:
            print("  " + line.strip())

    t0 = time.perf_counter()
    batches = [synth_packets(batch=BATCH, num_flows=FLOWS,
                             pkt_bytes=PKT_BYTES, seed=i)
               for i in range(N_BATCHES)]
    torch.cuda.synchronize()
    print(f"traffic: {N_BATCHES} x {BATCH} packets x {PKT_BYTES} B over "
          f"{FLOWS} flows on the card in {time.perf_counter() - t0:.2f} s")

    isg, dp = drive("ISG", ipsec_gateway, batches)
    print("main path " + json.dumps(isg))
    for k in ("flow_lookup", "dfa_regex", "keyed_hash", "arx_cipher"):
        if isg["launches"][k] < 1:
            raise AssertionError(f"ISG main path never launched {k}")
    ids, _ = drive("ID", intrusion_detection, batches)
    print("main path " + json.dumps(ids))
    for k in ("flow_lookup", "dfa_regex"):
        if ids["launches"][k] < 1:
            raise AssertionError(f"ID main path never launched {k}")

    kernels = kernel_checks(dp, batches[-1], isg["launches"],
                            ids["launches"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
