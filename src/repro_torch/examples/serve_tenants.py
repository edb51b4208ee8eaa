"""Meili-Serve demo: the 6-tenant mix on the paper cluster, diurnal traffic,
closed-loop autoscaling, and one injected NIC failure mid-run.

  PYTHONPATH=src python -m repro_torch.examples.serve_tenants \
      [--ticks 48] [--scenario diurnal] [--device cpu]

Prints a per-tick service table (offered/achieved Gbps, p99, units) for one
tenant, the autoscaler/failover event log, and the final SLO report.
"""
import argparse

from repro_torch.core.controller import MeiliController
from repro_torch.core.pool import paper_cluster
from repro_torch.service.runtime import RuntimeConfig, ServiceRuntime
from repro_torch.service.tenants import (TenantRegistry, contracts,
                                         default_tenant_mix)
from repro_torch.service.workload import make_scenario


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=48)
    ap.add_argument("--scenario", default="diurnal",
                    choices=("steady", "bursty", "diurnal", "churn",
                             "flash_crowd", "adversarial_churn"))
    ap.add_argument("--watch", default="t-fw", help="tenant to print per tick")
    ap.add_argument("--no-dataplane", action="store_true",
                    help="skip real fused-data-plane execution (analytic only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mix = default_tenant_mix()
    ctrl = MeiliController(paper_cluster())
    registry = TenantRegistry(ctrl)
    for spec in mix:
        registry.register(spec)
    workload = make_scenario(args.scenario, contracts(mix))
    cfg = RuntimeConfig(dataplane_every=0 if args.no_dataplane else 1)
    rt = ServiceRuntime(ctrl, registry, workload, cfg, device=args.device)
    admitted = registry.admit_all()
    print(f"admitted {len(admitted)} tenants: {admitted}")

    fail_tick = int(args.ticks * 0.6)
    rt.run(args.ticks, fail_at=(fail_tick, None))

    print(f"\n{args.watch} per-tick ({args.scenario}; NIC failure at tick "
          f"{fail_tick}):")
    print("tick  offered  achieved  p99(us)  units  event")
    for t in rt.telemetry.series(args.watch):
        print(f"{t.tick:4d}  {t.offered_gbps:7.2f}  {t.achieved_gbps:8.2f}"
              f"  {t.p99_s * 1e6:7.1f}  {t.units:5d}  {t.event}")

    print("\ncontroller events:")
    for e in ctrl.events:
        if e["event"] in ("scale", "failover"):
            tgt = f" target={e.get('target', 0):.1f}" if "target" in e else ""
            print(f"  {e['event']:8s} {e.get('tenant', ''):8s}"
                  f"{tgt}{' nic=' + e['nic'] if 'nic' in e else ''}")

    print("\nSLO report:")
    for tenant, r in rt.slo_report().items():
        print(f"  {tenant:8s} ticks={r['ticks']:3d} "
              f"violations={r['violations']:2d} pass={r['pass']}")
    print(f"\ntenants alive: {len(rt.alive_tenants())}/{len(mix)}")
    print(f"pool usage by tenant: {ctrl.pool.usage_snapshot()}")


if __name__ == "__main__":
    main()
