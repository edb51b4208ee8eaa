"""Multi-window multi-burn-rate alerting over SLO error budgets.

The SRE-workbook recipe, scaled from wall-time to ticks: an alert rule
pairs a *long* window (sustained burn — did this persist?) with a short
*confirm* window (is it still happening *now*?), and a condition fires
only when the burn rate over BOTH exceeds the rule's threshold. Two rules
by default:

  * ``page``  — fast long window ("1h-equivalent"), high burn multiple:
    the budget is being spent so fast the contract breaks within the
    rolling horizon unless someone acts.
  * ``warn``  — slow long window ("6h-equivalent"), lower multiple:
    sustained low-grade burn worth a look, not a wake-up.

(The wall-time equivalence is documented in DESIGN.md: at ``dt_s`` = 50 ms
a literal hour would be 72 000 ticks — far past any run — so windows are
expressed directly in ticks with the 1h:6h *ratio* preserved.)

Lifecycle: ``firing`` -> ``resolved`` with dedup (a firing alert never
re-fires) and hold-down (the condition must stay clear ``holddown_ticks``
consecutive evaluations before resolving, so a burn flickering around the
threshold cannot flap the alert). Every transition lands in the decision
trace (``slo_alert`` events, shard-labeled when a resolver is attached)
and in the metrics (``slo_alert_transitions_total``, ``slo_alerts_active``).

Transitions also drive the runtime's early-warning hook: ``on_page``
callbacks fire on every page-severity ``firing`` transition — the service
runtime uses this to pre-arm the gray-failure detector and request a
proactive ``scale_verdict`` consult before the contract actually breaks.

Determinism contract (tested): tenants and rules are evaluated in sorted /
declaration order and alert identity is (tenant, severity) — replaying the
same seeded scenario yields a byte-identical transition sequence, on the
legacy and the 1-shard sharded controller alike.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import Obs
from repro_torch.obs.slo import SLOEngine

PAGE = "page"
WARN = "warn"

FIRING = "firing"
RESOLVED = "resolved"


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """One multi-window burn condition: burn(long) and burn(confirm) must
    BOTH reach ``burn_threshold`` for the rule to hold."""

    severity: str
    window_ticks: int           # the long window
    confirm_ticks: int          # the short "still happening" window
    burn_threshold: float


DEFAULT_RULES: Tuple[BurnRule, ...] = (
    BurnRule(PAGE, window_ticks=8, confirm_ticks=2, burn_threshold=4.0),
    BurnRule(WARN, window_ticks=24, confirm_ticks=6, burn_threshold=2.0),
)


@dataclasses.dataclass
class AlertTransition:
    tick: int
    tenant: str
    severity: str
    state: str                  # firing | resolved
    burn_long: float
    burn_short: float

    def key(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _ActiveAlert:
    fired_tick: int
    clear_streak: int = 0       # consecutive evaluations below threshold


class BurnAlertManager:
    """Evaluates the burn rules once per tick against the SLO engine."""

    def __init__(self, engine: SLOEngine, obs: Obs,
                 rules: Sequence[BurnRule] = DEFAULT_RULES,
                 holddown_ticks: int = 4,
                 shard_resolver: Optional[Callable] = None):
        self.engine = engine
        self.obs = obs
        self.rules = tuple(rules)
        self.holddown_ticks = max(1, holddown_ticks)
        self.shard_resolver = shard_resolver
        self.transitions: List[AlertTransition] = []
        self.on_page: List[Callable[[str, AlertTransition], None]] = []
        self._active: Dict[Tuple[str, str], _ActiveAlert] = {}
        # step() runs every tick: resolve the gauge series once, and
        # precompute the ascending union of every rule's windows so each
        # tenant's burns come from a single walk (TenantBudget.burn_rates)
        self._active_gauge = obs.metrics.gauge("slo_alerts_active")
        self._windows = tuple(sorted(
            {w for r in self.rules
             for w in (r.window_ticks, r.confirm_ticks)}))
        # Budgets keep running bad-counts for exactly these windows, so
        # the per-tick evaluation is dict reads, not sample walks.
        engine.track_windows(self._windows)
        self._tenant_order: List[str] = []   # sorted; refreshed on growth
        self._active_per_tenant: Dict[str, int] = {}

    # -- evaluation ------------------------------------------------------------
    def step(self, tick: int) -> List[AlertTransition]:
        """One evaluation pass; returns the transitions it produced."""
        out: List[AlertTransition] = []
        budgets = self.engine.budgets
        if len(self._tenant_order) != len(budgets):
            self._tenant_order = sorted(budgets)   # budgets only grow
        for tenant in self._tenant_order:
            b = budgets[tenant]
            # An empty burn-tick ring means zero bad ticks inside the
            # widest tracked window, hence zero burn on every rule window
            # (they all nest inside it), so no rule can fire — and with no
            # active alert to resolve, the tenant needs no evaluation at
            # all. This is the steady-state fast path.
            if (not b._burn_ticks
                    and not self._active_per_tenant.get(tenant)):
                continue
            burns = b.burn_rates(self._windows)
            for rule in self.rules:
                burn_long = burns[rule.window_ticks]
                burn_short = burns[rule.confirm_ticks]
                hot = (burn_long >= rule.burn_threshold
                       and burn_short >= rule.burn_threshold)
                key = (tenant, rule.severity)
                st = self._active.get(key)
                if hot:
                    if st is None:
                        # fire (dedup: an already-firing alert stays put)
                        self._active[key] = _ActiveAlert(fired_tick=tick)
                        self._active_per_tenant[tenant] = \
                            self._active_per_tenant.get(tenant, 0) + 1
                        tr = self._transition(tick, tenant, rule.severity,
                                              FIRING, burn_long, burn_short)
                        out.append(tr)
                        if rule.severity == PAGE:
                            for fn in self.on_page:
                                fn(tenant, tr)
                    else:
                        st.clear_streak = 0
                elif st is not None:
                    st.clear_streak += 1
                    if st.clear_streak >= self.holddown_ticks:
                        del self._active[key]
                        self._active_per_tenant[tenant] -= 1
                        out.append(self._transition(
                            tick, tenant, rule.severity, RESOLVED,
                            burn_long, burn_short))
        self._active_gauge.set(len(self._active))
        return out

    def _transition(self, tick: int, tenant: str, severity: str,
                    state: str, burn_long: float,
                    burn_short: float) -> AlertTransition:
        tr = AlertTransition(tick=tick, tenant=tenant, severity=severity,
                             state=state, burn_long=burn_long,
                             burn_short=burn_short)
        self.transitions.append(tr)
        detail = dict(severity=severity, state=state,
                      burn_long=round(burn_long, 6),
                      burn_short=round(burn_short, 6))
        shard = (self.shard_resolver(tenant)
                 if self.shard_resolver is not None else None)
        if shard is not None:
            detail["shard"] = shard
        self.obs.trace.event("slo_alert", tenant=tenant, tick=tick, **detail)
        self.obs.metrics.counter("slo_alert_transitions_total",
                                 severity=severity, state=state).inc()
        return tr

    # -- inspection ------------------------------------------------------------
    def active(self) -> List[Tuple[str, str]]:
        return sorted(self._active)

    def sequence(self) -> str:
        """Canonical JSON of the full transition history — ticks, tenants,
        severities, states, and burn rates, in occurrence order. Two runs
        of the same seeded scenario must produce byte-identical strings
        (no wall-clock anywhere in an AlertTransition)."""
        return json.dumps([t.key() for t in self.transitions],
                          sort_keys=True)
