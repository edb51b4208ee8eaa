"""Seeded service runs in both packages, for the tests that hold the port's
service layer (``repro_torch.service``, ``core.faults``, ``core.shard``)
against the JAX package's.

``build`` makes the same runtime in either package: the same pool, tenant
mix, scenario, seed, ``RuntimeConfig``, recovery policy and fault plan,
with every clock fixed (``MeiliController(clock=)`` and ``Obs(clock=)``
both step 0.0, 0.25, 0.5, ... one step a reading), so the controller's
events and the trace's stamps come out alike. ``record`` takes what a run
leaves behind, and ``assert_same`` compares two records with ``==``: every
``TenantTick`` and ``ClusterTick``, the fault records, the alert
transitions, ``dataplane_stats()``, the controller's events, the registry
and recovery state, the pool's rows, the SLO report and summary, and the
``obs`` trace and metrics as the bytes ``Obs.dump`` writes.

Dropped before comparing, by name (``PROCESS_METRICS``): the process-wide
compile counters a data plane publishes. They count shape keys or jit
specializations seen by the whole process, so they depend on what ran
before in the same worker, not on the run. The histogram reservoirs are
seeded from ``hash``, salted per process: both packages run in one process.
"""
import dataclasses
import itertools
import json
import pathlib
import types

import repro.obs as jobs
from repro.core import controller as jctrl
from repro.core import faults as jfaults
from repro.core import pool as jpool
from repro.core import qos as jqos
from repro.core import shard as jshard
from repro.service import efficiency as jeff
from repro.service import runtime as jruntime
from repro.service import tenants as jtenants
from repro.service import workload as jworkload
from repro_torch import obs
from repro_torch.core import controller, faults, pool, qos, shard
from repro_torch.service import efficiency, runtime, tenants, workload

PORT = types.SimpleNamespace(
    name="port", ctrl=controller, faults=faults, pool=pool, qos=qos,
    shard=shard, obs=obs, runtime=runtime, tenants=tenants,
    workload=workload, eff=efficiency)
REF = types.SimpleNamespace(
    name="ref", ctrl=jctrl, faults=jfaults, pool=jpool, qos=jqos,
    shard=jshard, obs=jobs, runtime=jruntime, tenants=jtenants,
    workload=jworkload, eff=jeff)
PKGS = (PORT, REF)

# Metric series whose values are process history, not the run's.
PROCESS_METRICS = ("dataplane_dispatch_compiles", "compile_cache_")

FAST = dict(dataplane_every=0, max_sim_seqs=32)

# The chaos plan of the reference's shard and SLO tests (flap, gray,
# mid-migration crash, rack outage, repair), on the 8-NIC chaos pool.
CHAOS_POOL = dict(n_bf2=4, n_bf1=2, n_pensando=2)
CHAOS_EVENTS = (
    dict(tick=5, kind="flap", nic="bf2-1", duration_ticks=4),
    dict(tick=13, kind="gray", nic="bf2-2", fraction=0.25),
    dict(tick=21, kind="mid_migration"),
    dict(tick=27, kind="rack", rack="rack0"),
    dict(tick=34, kind="revive", rack="rack0"),
    dict(tick=34, kind="revive", nic="bf2-2"),
)


def fixed_clock():
    """0.0, 0.25, 0.5, ... one step per reading."""
    steps = itertools.count()
    return lambda: 0.25 * next(steps)


def chaos_mix(pkg, backups=("bf1-0", "bf1-1")):
    """The evaluation mix with its backups on the chaos pool's BF-1s."""
    return [dataclasses.replace(s, backup_nic=backups[i % len(backups)])
            for i, s in enumerate(pkg.tenants.default_tenant_mix())]


def build(pkg, scenario="bursty", *, seed=0, mix=None, pool_kw=None,
          sharded=False, staleness=4, cfg=None, recovery=None,
          scenario_kw=None, device="cpu"):
    """One seeded runtime, admitted and ready to run. ``mix`` is a function
    of the package (default: ``default_tenant_mix``); ``cfg`` and
    ``recovery`` are keyword dicts for ``RuntimeConfig`` (over ``FAST``)
    and ``RecoveryConfig``; ``device`` goes to the port's runtime only."""
    o = pkg.obs.Obs(clock=fixed_clock())
    cls = pkg.shard.ShardedController if sharded else pkg.ctrl.MeiliController
    kw = dict(staleness_ticks=staleness) if sharded else {}
    ctrl = cls(pkg.pool.paper_cluster(**(pool_kw or {})),
               clock=fixed_clock(), obs=o, **kw)
    registry = pkg.tenants.TenantRegistry(ctrl)
    specs = mix(pkg) if mix is not None else pkg.tenants.default_tenant_mix()
    for spec in specs:
        registry.register(spec)
    wl = pkg.workload.make_scenario(scenario, pkg.tenants.contracts(specs),
                                    seed=seed, **(scenario_kw or {}))
    rcfg = pkg.runtime.RuntimeConfig(**dict(FAST, **(cfg or {})))
    rec = (pkg.faults.RecoveryConfig(**recovery) if recovery is not None
           else None)
    dev = dict(device=device) if pkg is PORT else {}
    rt = pkg.runtime.ServiceRuntime(ctrl, registry, wl, rcfg,
                                    recovery=rec, **dev)
    registry.admit_all()
    return rt


def engine(pkg, events):
    """A ChaosEngine over ``events`` (FaultEvent keyword dicts), or None."""
    if not events:
        return None
    return pkg.faults.ChaosEngine(pkg.faults.FaultPlan(
        [pkg.faults.FaultEvent(**e) for e in events]))


def _rows(items):
    return [dataclasses.asdict(x) for x in items]


def _metrics_lines(path):
    keep = []
    for line in path.read_text().splitlines():
        name = json.loads(line).get("name", "")
        if not name.startswith(PROCESS_METRICS):
            keep.append(line)
    return keep


def _prom_lines(text):
    return [ln for ln in text.splitlines()
            if PROCESS_METRICS[0] not in ln
            and PROCESS_METRICS[1] not in ln]


def record(rt, out_dir):
    """Everything a run leaves behind, as plain data and dumped bytes."""
    ctrl, reg = rt.ctrl, rt.registry
    paths = rt.obs.dump(out_dir)
    with open(paths["trace"], "rb") as f:
        trace = f.read()
    return {
        "tenant_ticks": _rows(rt.telemetry.tenant_ticks),
        "cluster_ticks": _rows(rt.telemetry.cluster_ticks),
        "faults": _rows(rt.telemetry.faults()),
        "alerts": rt.alerts.sequence() if rt.alerts is not None else None,
        "dataplane": rt.dataplane_stats(),
        "events": json.dumps(ctrl.events, sort_keys=True, default=str),
        "admitted": sorted(reg.admitted), "rejected": dict(reg.rejected),
        "parked": sorted(reg.parked),
        "recovery": (list(rt.recovery.evicted),
                     list(rt.recovery.readmissions),
                     sorted(rt.recovery.parked)),
        "alive": rt.alive_tenants(),
        "pool": {n: (dict(st.free), st.free_bw_gbps, st.alive, st.gray_frac)
                 for n, st in ctrl.pool.nics.items()},
        "usage": ctrl.pool.usage_snapshot(),
        "slo_report": rt.slo_report(),
        "summary": rt.telemetry.summary(),
        "trace": trace,
        "metrics": _metrics_lines(pathlib.Path(paths["metrics"])),
        "prom": _prom_lines(pathlib.Path(paths["prom"]).read_text()),
    }


def assert_same(got, want):
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == want[k], k


def run_pair(tmp_path, ticks, events=(), **kw):
    """The same run in both packages; returns (port record, ref record,
    port runtime)."""
    recs = {}
    rts = {}
    for pkg in PKGS:
        rt = build(pkg, **kw)
        rt.run(ticks, chaos=engine(pkg, events))
        rt.ctrl.check_ledger()
        recs[pkg.name] = record(rt, tmp_path / pkg.name)
        rts[pkg.name] = rt
    return recs["port"], recs["ref"], rts["port"]
