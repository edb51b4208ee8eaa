"""The paper's six SmartNIC applications running on the Meili data plane
(Appendix F), with per-app throughput measurement on this device.

  PYTHONPATH=src python -m repro_torch.examples.nic_apps [--device cpu]
"""
import argparse
import time

from repro_torch.apps import ALL_APPS, synth_packets
from repro_torch.core.executor import ParallelDataPlane, _sync
from repro_torch.core.graph import run_pipeline


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pkts = synth_packets(batch=128, num_flows=16, pkt_bytes=512,
                         device=args.device)
    bits = float(pkts.length.sum()) * 8
    print(f"{'app':22s} {'stages':>6s} {'ms/batch':>9s} {'Gbps':>7s} "
          f"{'kept':>5s}  pipeline==oracle")
    for name, app in ALL_APPS().items():
        dp = ParallelDataPlane(app, num_pipelines=2,
                               capacity_per_pipeline=96, device=args.device)
        out = dp.process(pkts)                     # warm up
        _sync(pkts.device)
        t0 = time.perf_counter()
        out = dp.process(pkts)
        _sync(pkts.device)
        dt = time.perf_counter() - t0
        oracle = run_pipeline(app, pkts)
        ok = bool((out.mask == oracle.mask).all())
        print(f"{app.name:22s} {len(app.stages):6d} {dt*1e3:9.1f} "
              f"{bits/dt/1e9:7.2f} {int(out.mask.sum()):5d}  {ok}")


if __name__ == "__main__":
    main()
