"""Render the dry run's tables from its JSON records, as the reference's
``launch/report.py``.

  PYTHONPATH=src python -m repro_torch.launch.report build/dryrun

Columns keep the reference's names. On the card "compile s" is the time
the step's trace on the meta device took, "temp GB/chip" the predicted
peak less the step's arguments, and the collective column is 0 (one
card). Analytic records (``single``/``multi``) carry no roofline.
"""
from __future__ import annotations

import glob
import json
import os
import sys


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b / 1e9:.2f}"


def load(d):
    recs = {}
    for f in glob.glob(os.path.join(d, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r.get("mesh", "skip"))] = r
    return recs


def dryrun_table(recs, mesh="card"):
    rows = ["| arch | shape | status | compile s | temp GB/chip | accum | "
            "HLO GFLOP/dev | coll GB/dev |",
            "|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(recs.items()):
        if m == "skip":
            rows.append(f"| {a} | {s} | SKIP ({r['reason'][:42]}…) | - | - | "
                        f"- | - | - |")
            continue
        if m != mesh:
            continue
        if r["status"] != "ok":
            rows.append(f"| {a} | {s} | **FAIL** | - | - | - | - | - |")
            continue
        roof = r.get("roofline")
        gflop = f"{roof['flops_per_device'] / 1e9:.1f}" if roof else "-"
        coll = f"{roof['coll_bytes_per_device'] / 1e9:.2f}" if roof else "-"
        rows.append(
            f"| {a} | {s} | ok | {r['compile_s']:.0f} | "
            f"{fmt_bytes(r['memory'].get('temp_size_bytes'))} | "
            f"{r.get('accum', '-')} | {gflop} | {coll} |")
    return "\n".join(rows)


def roofline_table(recs, mesh="card"):
    rows = ["| arch | shape | t_comp s | t_mem s | t_coll s | dominant | "
            "useful | roofline frac | one-line lever |",
            "|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(recs.items()):
        if m != mesh or r.get("status") != "ok" or "roofline" not in r:
            continue
        roof = r["roofline"]
        lever = _lever(roof, r)
        rows.append(
            f"| {a} | {s} | {roof['t_compute']:.3f} | {roof['t_memory']:.3f} "
            f"| {roof['t_collective']:.3f} | {roof['dominant']} | "
            f"{roof['useful_flops_ratio']:.3f} | "
            f"{roof['roofline_fraction']:.4f} | {lever} |")
    return "\n".join(rows)


def _lever(roof, r):
    """The H100 lever for the step's dominant term."""
    mem = r.get("memory", {})
    if mem.get("fits") is False:
        return ("does not fit one card: cut depth or batch, or shard over "
                "cards (expert-parallel slice)")
    if r.get("shape", "").startswith(("decode", "long")):
        return ("host-bound at one token a step: capture the decode step "
                "in a CUDA graph")
    if roof["dominant"] == "memory":
        return ("fuse the eager elementwise chains around the kernels "
                "(each op reads and writes HBM)")
    return ("raise the kernels' bound share (tensor-core products at "
            "the step's dtype)")


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun"
    recs = load(d)
    for mesh in ("card", "single", "multi"):
        if not any(m == mesh for (_, _, m) in recs):
            continue
        print(f"\n### Dry-run — {mesh}\n")
        print(dryrun_table(recs, mesh))
        print(f"\n### Roofline — {mesh}\n")
        print(roofline_table(recs, mesh))


if __name__ == "__main__":
    main()
