"""SLO error-budget engine: telemetry becomes judgment.

Each tenant's SLA (``service.tenants.TenantSLA``) defines a per-tick
service-level indicator: the tick is *good* when achieved throughput holds
``min_tput_frac`` of the serviceable contract (``min(offered, target)``)
AND the measured p99 (``p99_measured_s``; legacy ``p99_s`` as fallback
while the histogram is empty) stays under the latency target. The *error
budget* over a rolling ``horizon_ticks`` window is ``budget_frac`` of the
window — the fraction of ticks the tenant is contractually allowed to be
bad — and the **burn rate** over any sub-window is

    burn(W) = bad_ticks(W) / W / budget_frac

i.e. 1.0 means "spending the budget exactly as fast as the contract
allows"; the multi-window alert manager (``obs.alerts``) pages on
sustained multiples of that.

Grace ticks (post-failover/migration windows) DO burn budget: grace is the
pool forgiving *itself* in ``slo_report`` accounting, but the tenant still
experienced the degradation — which is exactly what makes the burn-rate
alert an early warning: it fires on in-grace burn *before* the first
violating tick the SLO report would count. Warmup ticks burn nothing (the
model is still settling; ``slo_report`` skips them too).

``why_slo(tenant)`` joins the budget ledger to the decision trace: it pulls
the whole burn window through the range form of ``DecisionTrace.why`` (one
span-closed query) and returns the burned ticks, the
remaining budget, and the causally-ordered events that spent it.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.obs import Obs


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Per-tenant budget terms, derived from the TenantSpec SLA."""

    target_gbps: float
    p99_target_s: float
    min_tput_frac: float        # achieved >= frac * min(offered, target)
    budget_frac: float          # allowed bad-tick fraction of the horizon
    horizon_ticks: int

    @classmethod
    def from_sla(cls, sla, horizon_ticks: int) -> "SLOPolicy":
        return cls(
            target_gbps=sla.target_gbps,
            p99_target_s=sla.p99_latency_s,
            # Older TenantSLA instances predate the budget fields.
            min_tput_frac=getattr(sla, "min_tput_frac", 0.9),
            budget_frac=getattr(sla, "budget_frac", 0.05),
            horizon_ticks=horizon_ticks)


@dataclasses.dataclass(slots=True)
class BurnSample:
    """One BURNED tick in a tenant's budget ledger. Good ticks are not
    materialised — their full telemetry already lives in the TenantTick
    log; the budget keeps only its judgments (the 0/1 window) plus the
    evidence for each tick it judged bad."""

    tick: int
    bad: bool
    p99_s: float
    achieved_gbps: float
    expected_gbps: float
    in_grace: bool
    reason: str = ""            # "", "tput", "p99", "tput+p99"


class TenantBudget:
    """Rolling-horizon budget ledger for one tenant."""

    def __init__(self, policy: SLOPolicy):
        self.policy = policy
        self.window: Deque[int] = collections.deque(
            maxlen=policy.horizon_ticks)
        self.samples: List[BurnSample] = []    # burned ticks only
        self.bad_total = 0
        self.first_tick: Optional[int] = None  # first/last scored tick
        self.last_tick: Optional[int] = None
        self.prev_bad = False                  # last scored tick burned?
        self._window_bad = 0        # running sum of the deque (hot path)
        # Burn-tick ring for the alert manager's windows: the ticks of the
        # burns inside the widest tracked window, ascending. Steady state
        # (no recent burn) keeps it empty, so record_tick() pays ONE
        # emptiness check instead of per-window bookkeeping, and
        # burn_rates() derives every tracked window's count from this one
        # short deque only while actually burning.
        self._burn_ticks: Deque[int] = collections.deque()
        self._tracked: set = set()
        self._max_tracked = 0
        self._allow = max(policy.budget_frac * policy.horizon_ticks, 1e-9)

    def track_windows(self, windows) -> None:
        """Serve these windows from the burn-tick ring. Windows wider than
        the horizon are capped at it — the sample window itself never
        holds more than ``horizon_ticks`` entries, so the walking path
        they replace had the same cap."""
        maxlen = self.window.maxlen or 0
        new = [w for w in windows if w not in self._tracked]
        if not new:
            return
        self._tracked.update(new)
        mt = min(max(self._tracked), maxlen) if maxlen \
            else max(self._tracked)
        if mt != self._max_tracked:
            self._max_tracked = mt
            # Rebuild from the trailing window (scored ticks are
            # consecutive, so offset i from the right is last_tick - i).
            bt = self._burn_ticks
            bt.clear()
            if self.last_tick is not None:
                span = min(mt, len(self.window))
                for i, v in enumerate(itertools.islice(
                        reversed(self.window), span)):
                    if v:
                        bt.appendleft(self.last_tick - i)

    def record_tick(self, tick: int, bad: bool) -> None:
        """Score one tick into the window + burn-tick ring. The caller
        appends a BurnSample to ``samples`` only when ``bad`` (good ticks
        allocate nothing — this runs per tenant per tick)."""
        win = self.window
        if len(win) == win.maxlen:
            self._window_bad -= win[0]   # maxlen evicts silently
        if self.first_tick is None:
            self.first_tick = tick
        self.last_tick = tick
        self.prev_bad = bad
        bt = self._burn_ticks
        if bad:
            win.append(1)
            self.bad_total += 1
            self._window_bad += 1
            if self._max_tracked:
                bt.append(tick)
        else:
            win.append(0)
        if bt and bt[0] <= tick - self._max_tracked:
            horizon = tick - self._max_tracked
            while bt and bt[0] <= horizon:
                bt.popleft()

    def push(self, sample: BurnSample) -> None:
        """Back-compat single-call form of ``record_tick`` + ledger."""
        self.record_tick(sample.tick, sample.bad)
        if sample.bad:
            self.samples.append(sample)

    def burned(self) -> int:
        """Bad ticks inside the rolling horizon."""
        return self._window_bad

    def allowance(self) -> float:
        """Bad ticks the horizon's budget permits."""
        return self.policy.budget_frac * self.policy.horizon_ticks

    def remaining_frac(self) -> float:
        """Fraction of the rolling budget still unspent (clamped at 0)."""
        r = 1.0 - self._window_bad / self._allow
        return r if r > 0.0 else 0.0

    def burn_rate(self, window_ticks: int) -> float:
        """Observed burn over the trailing ``window_ticks``, as a multiple
        of the allowed steady-state burn (1.0 = spending on schedule)."""
        w = max(1, min(window_ticks, len(self.window))) \
            if self.window else max(1, window_ticks)
        # no list copy: walk the trailing w entries from the right
        bad = sum(itertools.islice(reversed(self.window), w))
        return (bad / w) / max(self.policy.budget_frac, 1e-9)

    def burn_rates(self, windows) -> Dict[int, float]:
        """``burn_rate`` for several windows at once — the alert manager
        needs every rule's long + confirm window each tick. Tracked
        windows (``track_windows``) count the burn-tick ring (a handful
        of entries, and only non-empty while burning); untracked ones
        share ONE right-to-left walk. ``windows`` must be ascending; the
        math is identical to ``burn_rate`` per window."""
        n = len(self.window)
        maxlen = self.window.maxlen or 0
        inv = 1.0 / max(self.policy.budget_frac, 1e-9)
        tracked = self._tracked
        bt = self._burn_ticks
        last = self.last_tick
        out: Dict[int, float] = {}
        it = None
        bad = seen = 0
        for w in windows:
            eff = max(1, min(w, n)) if n else max(1, w)
            if w in tracked and last is not None:
                cut = last - min(w, maxlen or w)
                c = 0
                for t in reversed(bt):
                    if t > cut:
                        c += 1
                    else:
                        break
            else:
                if it is None:
                    it = reversed(self.window)
                while seen < eff:
                    bad += next(it)
                    seen += 1
                c = bad
            out[w] = (c / eff) * inv
        return out

    def burned_ticks(self) -> List[int]:
        return [s.tick for s in self.samples]


class SLOEngine:
    """The per-tick judge: scores TenantTicks against SLA-derived budgets,
    exports remaining-budget gauges, and answers ``why_slo``."""

    def __init__(self, obs: Obs, horizon_ticks: int = 64,
                 warmup_ticks: int = 0,
                 shard_resolver: Optional[Callable] = None):
        self.obs = obs
        self.horizon_ticks = horizon_ticks
        self.warmup_ticks = warmup_ticks
        self.shard_resolver = shard_resolver
        self.budgets: Dict[str, TenantBudget] = {}
        # Hot path runs once per tenant per tick: resolve the labeled
        # metric series once per tenant, not once per call.
        self._gauges: Dict[str, object] = {}
        self._counters: Dict[str, object] = {}
        self._tracked_windows: tuple = ()

    def track_windows(self, windows) -> None:
        """Register alert-rule windows so every budget (existing and
        future) maintains running counters for them (see
        ``TenantBudget.track_windows``)."""
        self._tracked_windows = tuple(sorted(
            set(self._tracked_windows) | set(windows)))
        for b in self.budgets.values():
            b.track_windows(self._tracked_windows)

    def budget(self, tenant: str, sla) -> TenantBudget:
        b = self.budgets.get(tenant)
        if b is None:
            b = TenantBudget(SLOPolicy.from_sla(sla, self.horizon_ticks))
            if self._tracked_windows:
                b.track_windows(self._tracked_windows)
            self.budgets[tenant] = b
        return b

    def observe(self, tt, sla) -> bool:
        """Score one TenantTick; returns whether it burned budget. Emits a
        ``slo_burn`` trace event at the START of each burn streak (a
        per-burned-tick event would dominate the layer's own overhead
        budget under sustained chaos; the burned-tick ledger lives in
        ``samples``/``burn_reasons``, and good ticks stay in the telemetry
        log) and keeps the ``slo_budget_remaining``/``slo_burned_ticks``
        series current."""
        b = self.budget(tt.tenant, sla)
        pol = b.policy
        p99 = tt.p99_measured_s if tt.p99_measured_s > 0.0 else tt.p99_s
        expect = min(tt.offered_gbps, pol.target_gbps)
        tput_bad = tt.achieved_gbps < pol.min_tput_frac * expect - 1e-12
        p99_bad = p99 > pol.p99_target_s
        warm = tt.tick < self.warmup_ticks
        bad = (tput_bad or p99_bad) and not warm
        streak_start = bad and not b.prev_bad
        b.record_tick(tt.tick, bad)
        if bad:
            reason = ("tput+p99" if tput_bad and p99_bad
                      else "tput" if tput_bad else "p99")
            b.samples.append(BurnSample(
                tick=tt.tick, bad=True, p99_s=p99,
                achieved_gbps=tt.achieved_gbps, expected_gbps=expect,
                in_grace=tt.in_grace, reason=reason))
        g = self._gauges.get(tt.tenant)
        if g is None:
            g = self._gauges[tt.tenant] = self.obs.metrics.gauge(
                "slo_budget_remaining", tenant=tt.tenant)
        r = b.remaining_frac()
        if g.value != r:        # steady state: unchanged, skip the set
            g.set(r)
        if bad:
            c = self._counters.get(tt.tenant)
            if c is None:
                c = self._counters[tt.tenant] = self.obs.metrics.counter(
                    "slo_burned_ticks_total", tenant=tt.tenant)
            c.inc()
            if streak_start:
                detail = dict(reason=reason, p99_s=p99,
                              p99_target_s=pol.p99_target_s,
                              achieved_gbps=tt.achieved_gbps,
                              expected_gbps=expect, in_grace=tt.in_grace,
                              budget_remaining=b.remaining_frac())
                shard = (self.shard_resolver(tt.tenant)
                         if self.shard_resolver is not None else None)
                if shard is not None:
                    detail["shard"] = shard
                self.obs.trace.event("slo_burn", tenant=tt.tenant,
                                     tick=tt.tick, **detail)
        return bad

    def burn_rate(self, tenant: str, window_ticks: int) -> float:
        b = self.budgets.get(tenant)
        return b.burn_rate(window_ticks) if b is not None else 0.0

    def why_slo(self, tenant: str) -> dict:
        """The budget narrative: how much burned, when, and the trace spans
        and decisions that spent it — one span-closed range query over the
        whole burn window."""
        b = self.budgets.get(tenant)
        if b is None or b.last_tick is None:
            return {"tenant": tenant, "tracked": False}
        burned = b.burned_ticks()
        lo = burned[0] if burned else b.first_tick
        hi = burned[-1] if burned else b.last_tick
        events = self.obs.trace.why(tenant, tick_lo=lo, tick_hi=hi)
        story = [{"seq": e.seq, "tick": e.tick, "kind": e.kind,
                  "name": e.name, "nic": e.nic, "phase": e.phase,
                  "detail": dict(e.detail)} for e in events]
        return {
            "tenant": tenant,
            "tracked": True,
            "policy": dataclasses.asdict(b.policy),
            "burned_ticks": burned,
            "burned_in_window": b.burned(),
            "allowance_ticks": b.allowance(),
            "remaining_frac": b.remaining_frac(),
            "burn_window": [lo, hi],
            "burn_reasons": {s.tick: s.reason for s in b.samples},
            "events": story,
        }
