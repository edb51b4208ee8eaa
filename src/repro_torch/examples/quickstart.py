"""Quickstart: build a Meili app, submit it with a throughput target, watch
the controller plan/place/scale it — the paper's §2.2 workflow end-to-end.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.apps import ALL_APPS, synth_packets
from repro_torch.core import MeiliController, ParallelDataPlane, paper_cluster
from repro_torch.core.graph import run_pipeline
from repro_torch.core.profiler import measure_app


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. The pool: the paper's rack (8x BF-2, 4x BF-1, 4x Pensando).
    pool = paper_cluster()
    ctrl = MeiliController(pool)
    print(f"pool: {len(pool.names())} NICs, "
          f"{pool.total('cpu')} cores, {pool.total('regex')} regex, "
          f"{pool.total('crypto')} crypto engines")

    # 2. An application: IPsec Gateway (Listing 1) — needs CPU + regex + AES,
    #    which no single NIC type provides: only pooling can host it.
    app = ALL_APPS()["ISG"]
    print(f"\napp '{app.name}': stages {app.stage_names()}")

    # 3. Offline profiling (one resource unit per stage, paper §6.1), on the
    #    device that holds the packets.
    pkts = synth_packets(batch=64, num_flows=8, pkt_bytes=256,
                         device=args.device)
    prof = measure_app(app, pkts, iters=3)
    print("profiled stage latencies (ms/batch):",
          {s: round(l * 1e3, 2) for s, l in prof.l_s.items()})
    print(f"single-pipeline: {prof.t_p:.3f} Gbps, latency {prof.l_p*1e3:.1f} ms")

    # 4. Submit with a throughput target -> Algorithm 1 R + Algorithm 2 place.
    #    Two minimal-granularity units per stage: ISG's sha AND aes stages
    #    both bind to the pool's 4 crypto engines, so a 4-units-per-stage
    #    target would over-demand crypto 8 > 4 and leave aes unplaced.
    dep = ctrl.submit(app, target_gbps=min(2.0, prof.t_p * 2), profile=prof)
    print(f"\nreplication R = {dep.R}")
    print(f"pipelines: {dep.num_pipelines}, achievable {dep.achievable_gbps:.2f} Gbps")
    for s in app.stage_names():
        print(f"  {s:14s} -> {dep.allocation.nics_for(s)}")

    # 5. Run traffic through the replicated data plane; semantics preserved.
    dp = ParallelDataPlane(app, num_pipelines=dep.num_pipelines,
                           capacity_per_pipeline=32, device=args.device)
    out = dp.process(pkts)
    oracle = run_pipeline(app, pkts)
    same = bool((out.mask == oracle.mask).all())
    print(f"\nparallel data plane == single-pipeline oracle: {same}")
    print(f"packets kept: {int(out.mask.sum())}/{out.batch} "
          f"(dropped by ddos/url filters)")

    # 6. Adaptive scaling + failover.
    dep = ctrl.adaptive_scale(app.name, dep.achievable_gbps * 1.5)
    print(f"\nafter scale-up: units {dep.r_s} achievable "
          f"{dep.achievable_gbps:.2f} Gbps")
    aes_nics = dep.allocation.nics_for("aes")
    victim = aes_nics[0] if aes_nics else dep.nics_used()[0]
    ctrl.handle_failure(victim)
    dep = ctrl.deployments[app.name]
    print(f"after {victim} failure: aes now on "
          f"{dep.allocation.nics_for('aes')}, achievable "
          f"{dep.achievable_gbps:.2f} Gbps")


if __name__ == "__main__":
    main()
