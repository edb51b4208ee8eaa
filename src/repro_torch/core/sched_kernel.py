"""Vectorized per-tick scheduling kernel: tenants as rows of stacked tensors.

The scalar control path (``ResourceGovernor.dwrr_schedule``, the runtime's
backlog math, ``TelemetryLog``'s per-tenant reduction) walks a Python dict
per tenant per tick — fine at 6 tenants, a wall at the 1000-tenant /
500-NIC scale the ROADMAP targets. Following *Wave* (offload the resource-
management fast path to the device), this module re-expresses the per-tick
fast path as a dense tensor program over ALL tenants at once, on the
scheduler's device (the card by default):

  ``dwrr_step``          one deficit-weighted round-robin tick. The scalar
                         reference serves tenants sequentially within a
                         round; the kernel exploits that within one round the
                         budget consumed before visit position *i* is
                         ``cumsum(desired)[:i]`` — so each round is one
                         vectorized expression with no per-tenant host work.
  ``dwrr_uncapped``      the order-only mode (``capacity_bytes=None``): every
                         queue drains to its own cap, DWRR only ranks.
  ``refill_credits``     burst token-bucket refill, all buckets at once.
  ``queue_drain``        the backlog/queue-drain math from
                         ``measure_tenant_tick`` (arrivals, served, carry).
  ``scale_decisions``    the quota/pressure/brownout clamps of
                         ``scale_verdict`` as a dense program: the fast path
                         computes every tenant's grant and flags the sparse
                         set that needs a host-side rescale.
  ``telemetry_accumulate``  running per-tenant sums/maxes — the
                         ``TelemetryLog`` reduction as one fused update.

Array layout: one row per tenant, rows pinned in the governor's
deterministic priority order (weight descending, then name), padded to the
next power of two so churn re-pads instead of adding a shape. Deficits live
on the scheduler's device: they persist across ticks and come to the host
only when membership changes (``sync``) or for ``deficit()``, never in the
hot loop.

The round loop. An eager loop that read the loop condition every round
would wait for the device once a round. Instead every round is a no-op on
rounds where the condition is false (a device-side ``live`` flag masks the
runnable and visited sets, and the round counter advances only while
live), so rounds run in fixed blocks of ``ROUNDS_PER_CHECK`` and the
condition comes to the host once a block, with the round count. The result
does not depend on the block size. The ring stays in the base frame: each
round gathers the desired takes into visit order for the budget's cumsum,
so no ``roll`` needs a host offset.

Two departures from the JAX package's kernel, both toward the scalar
oracle. (1) The ring rotates over the live rows only, as the scalar ring
does; the JAX kernel rolls over the padded rows, so once its ring offset
passes the live count it visits rows unrotated while the scalar keeps
rotating (at 200 tenants in 256 rows its ticks leave the contract from
the 26th on). (2) A round that the budget truncates ends with the budget
exactly 0, as the scalar walk's ``budget - take`` does; the f32 sum of the
takes can leave more than ``_EPS`` and run one round the scalar does not.

Shape keys. ``trace_counts`` keeps the meaning of the JAX package's trace
counter: a call whose (function, input shapes and dtypes, device, static
arguments) key is new in the process counts one, and a steady-state tick
counts none. ``host_reads`` counts the device-to-host reads this module
makes (one per block of rounds, one for a tick's served bytes and stamps).

The scalar path in ``core/qos.py`` stays the pinned reference oracle;
``tests/test_torch_sched_kernel.py`` holds every kernel against it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.hw import resolve_device

# Must match core.qos._EPS: the kernels replicate the scalar oracle's
# epsilon decisions (take > eps, budget > eps, runnable checks) exactly.
_EPS = 1e-9

# Rounds run between two reads of the loop condition (see module doc).
ROUNDS_PER_CHECK = 16

# The contract against the scalar oracle (``contract_errors``): relative and
# absolute slack for f32 kernel against f64 scalar on O(1e4)-byte budgets.
RTOL = 5e-4
ATOL = 1e-2

# New shape keys per kernel since ``reset_trace_counts`` (the JAX package
# counts traces; here a key seen for the first time in the process counts),
# the keys seen in the process (never reset, as a compile cache is not), and
# device-to-host reads per kernel since ``reset_host_reads``.
_TRACE_COUNTS: Dict[str, int] = {}
_SEEN_KEYS: set = set()
_HOST_READS: Dict[str, int] = {}


def _count_trace(name: str, *args, static: tuple = ()) -> None:
    key = (name, static) + tuple(
        (tuple(a.shape), a.dtype, a.device) for a in args)
    if key not in _SEEN_KEYS:
        _SEEN_KEYS.add(key)
        _TRACE_COUNTS[name] = _TRACE_COUNTS.get(name, 0) + 1


def trace_counts() -> Dict[str, int]:
    """New shape keys per kernel since ``reset_trace_counts`` (steady state
    must not grow these)."""
    return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    _TRACE_COUNTS.clear()


def _to_host(name: str, t: torch.Tensor) -> np.ndarray:
    """The one way this module reads a tensor back (counted per kernel)."""
    _HOST_READS[name] = _HOST_READS.get(name, 0) + 1
    return t.cpu().numpy()


def host_reads() -> Dict[str, int]:
    """Device-to-host reads per kernel since ``reset_host_reads``."""
    return dict(_HOST_READS)


def reset_host_reads() -> None:
    _HOST_READS.clear()


def contract_errors(order_s: List[str], served_s: Dict[str, float],
                    order_k: List[str], served_k: Dict[str, float],
                    budget: float, weights: Dict[str, float],
                    check_order: bool = True) -> List[str]:
    """Where a kernel tick breaks its contract with the scalar oracle's tick
    (the JAX package's ``_assert_equivalent``); empty when it holds.

    f32 kernel vs f64 scalar: where the budget truncates the final round can
    land one visit position apart, redistributing at most ~one round's
    deficit earn (``quantum * weight``) between adjacent rows — DWRR's
    service granularity. So each tenant's served bytes agree within
    ``max(ATOL, 1.05 * quantum * weight + RTOL * served)``. The dispatch
    order of substantively served tenants (more than ``1e-3`` of the
    budget) must agree from a fresh ring (``check_order``); once a budget
    boundary shifts the round count by one, the two rings rotate out of
    phase and orders legitimately differ."""
    errs = []
    if set(order_s) != set(order_k):
        errs.append(f"tenants {sorted(set(order_s) ^ set(order_k))} are in "
                    f"one order only")
    total_w = sum(weights.values()) or 1.0
    quantum = budget / (8.0 * total_w)
    for t in served_s:
        tol = max(ATOL, 1.05 * quantum * weights[t] + RTOL * served_s[t])
        if abs(served_k[t] - served_s[t]) > tol:
            errs.append(f"{t}: served {served_k[t]} against the scalar "
                        f"{served_s[t]} (tolerance {tol})")
    if check_order:
        floor = max(ATOL, 1e-3 * budget)
        sub_s = [t for t in order_s if served_s[t] > floor]
        sub_k = [t for t in order_k if served_s[t] > floor]
        if sub_s != sub_k:
            errs.append(f"dispatch order {sub_k} against the scalar {sub_s}")
    return errs


def pad_rows(n: int, minimum: int = 8) -> int:
    """Pow-2 row bucketing: tenant churn re-pads instead of adding a key."""
    size = minimum
    while size < n:
        size *= 2
    return size


# -- DWRR ----------------------------------------------------------------------

def dwrr_step(queues: torch.Tensor, weights: torch.Tensor,
              deficits: torch.Tensor, caps: torch.Tensor, mask: torch.Tensor,
              budget: torch.Tensor, ring_offset: int, max_rounds: int = 1024
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One capped DWRR tick over stacked tenant rows (f32, one device).

    Mirrors the scalar ``ResourceGovernor.dwrr_schedule`` capped branch:
    per round, visit the live rows (``mask > 0``) in ring order (their row
    order rotated by ``ring_offset + round``, modulo the live count, the
    other rows after them); runnable rows earn ``quantum * weight`` of
    deficit and take ``min(queue, deficit, cap - served, budget_left)``;
    idle rows forfeit their deficit; the round loop stops when the budget
    or the runnable set is exhausted, or after ``max_rounds``. Within a
    round the sequential budget is vectorized via the cumulative-desired
    identity (see module doc).

    Returns ``(served, new_deficits, stamps, rounds)``: tensors on the
    inputs' device and the round count on the host. ``stamps[i]`` is the
    global visit position of row *i*'s first non-zero take (-1 = never
    served) — the host derives the dispatch order from it.
    """
    _count_trace("dwrr_step", queues, weights, deficits, caps, mask, budget,
                 static=(max_rounds,))
    n = queues.shape[0]
    dev = queues.device
    idx = torch.arange(n, device=dev)
    m = mask > 0.0
    total_w = torch.where(m, weights, 0.0).sum()
    total_w = torch.where(total_w > 0.0, total_w, 1.0)
    b = budget.clamp_min(0.0)
    quantum = b / (8.0 * total_w + 1e-9)
    q = queues.clamp_min(0.0)
    served = torch.zeros_like(queues)
    d = deficits
    stamps = torch.full((n,), -1, dtype=torch.int32, device=dev)
    r = torch.zeros((), dtype=torch.int32, device=dev)
    # The ring is the live rows, in row order: live row i has live rank
    # rank[i], and a round rotates the ranks modulo the live count. Rows
    # outside the mask sit after every live row and never take.
    live_rows = m.to(torch.int64)
    n_live = live_rows.sum().clamp_min(1)
    rank = torch.where(m, torch.cumsum(live_rows, 0) - 1,
                       n_live + torch.cumsum(1 - live_rows, 0) - 1)

    def cond():
        runnable_any = (m & (q > _EPS) & (served < caps - _EPS)).any()
        return (r < max_rounds) & (b > _EPS) & runnable_any

    live = cond()
    while True:
        for _ in range(ROUNDS_PER_CHECK):
            # Visit position j of this round holds base row perm[j]; base row
            # i sits at position pos[i]. Past the loop's end (live false)
            # nothing is runnable or visited, so the round changes nothing.
            shift = (r.to(torch.int64) + ring_offset) % n_live
            pos = torch.where(m, (rank - shift) % n_live, rank)
            perm = torch.empty_like(pos).scatter_(0, pos, idx)
            runnable = m & (q > _EPS) & (served < caps - _EPS) & live
            d_inc = torch.where(runnable, d + quantum * weights, d)
            desired = torch.where(
                runnable,
                torch.minimum(torch.minimum(q, d_inc), caps - served), 0.0)
            desired_v = desired[perm]
            prev_v = torch.cat([desired_v.new_zeros(1),
                                torch.cumsum(desired_v, 0)[:-1]])
            # Sequential-budget identity: rows before the truncation point
            # take their full desired, the truncated row takes the remainder,
            # rows after take nothing — exactly the scalar walk's outcome.
            avail_v = b - prev_v
            take_v = torch.minimum(avail_v.clamp_min(0.0), desired_v)
            take_v = torch.where(take_v > _EPS, take_v, 0.0)
            # The scalar walk breaks AFTER the row that exhausts the budget:
            # later rows are unvisited (no deficit earn, no idle forfeit).
            visited_v = avail_v > _EPS
            visited = visited_v[pos] & live
            take = take_v[pos]
            # The row the budget truncates takes what is left, and the scalar
            # walk's ``budget - take`` is then exactly 0. ``b - sum(take)``
            # rounds in f32 and can leave more than _EPS, which would run a
            # round the scalar walk does not; so a truncated round ends the
            # budget exactly.
            cut = (visited_v & (avail_v <= desired_v)).any()
            d = torch.where(visited & runnable, d_inc - take,
                            torch.where(visited & ~runnable & m, 0.0, d))
            stamps = torch.where((take > _EPS) & (stamps < 0),
                                 (r * n + pos).to(torch.int32), stamps)
            q = q - take
            served = served + take
            b = torch.where(cut, 0.0, b - take_v.sum())
            r = r + live.to(torch.int32)
            live = cond()
        live_h, rounds = _to_host("dwrr_step",
                                  torch.stack([live.to(torch.int32), r]))
        if not live_h:
            return served, d, stamps, int(rounds)


def dwrr_uncapped(queues: torch.Tensor, weights: torch.Tensor,
                  caps: torch.Tensor, mask: torch.Tensor):
    """Order-only mode (``capacity_bytes=None``): each queue drains to its
    own cap; the returned key ranks dispatch most-owed-first (weighted
    backlog descending — the scalar path's exact sort key)."""
    _count_trace("dwrr_uncapped", queues, weights, caps, mask)
    q = queues.clamp_min(0.0)
    served = torch.where(mask > 0.0, torch.minimum(q, caps), 0.0)
    return served, q * weights


# -- burst buckets / backlog ---------------------------------------------------

def refill_credits(credits: torch.Tensor, depth: torch.Tensor,
                   refill: torch.Tensor) -> torch.Tensor:
    """Token-bucket refill for every tenant at once (scalar reference:
    the ``begin_tick`` credit loop)."""
    _count_trace("refill_credits", credits, depth, refill)
    out = torch.minimum(depth, credits + refill)
    return torch.where(depth > 0.0, out, credits)


def queue_drain(offered_pps: torch.Tensor, backlog_pkts: torch.Tensor,
                cap_pps: torch.Tensor, served_pkts: torch.Tensor,
                dt_s: torch.Tensor):
    """The backlog/queue-drain math of ``measure_tenant_tick`` (arrivals,
    service, carried backlog, achieved pps), all tenants at once."""
    _count_trace("queue_drain", offered_pps, backlog_pkts, cap_pps,
                 served_pkts, dt_s)
    arriving = offered_pps.clamp_min(0.0) * dt_s + backlog_pkts.clamp_min(0.0)
    served = torch.minimum(arriving, cap_pps.clamp_min(0.0) * dt_s)
    served = torch.minimum(served, served_pkts.clamp_min(0.0))
    new_backlog = arriving - served
    achieved_pps = torch.where(dt_s > 0.0, served / dt_s, 0.0)
    return served, new_backlog, achieved_pps


# -- governor fast path --------------------------------------------------------

def scale_decisions(est_gbps: torch.Tensor, offered_gbps: torch.Tensor,
                    contract_gbps: torch.Tensor, current_gbps: torch.Tensor,
                    achievable_gbps: torch.Tensor, quota_gbps: torch.Tensor,
                    credits: torch.Tensor, weights: torch.Tensor,
                    brownout: torch.Tensor, wmax: torch.Tensor,
                    headroom: torch.Tensor, floor_frac: torch.Tensor,
                    pressure_frac: torch.Tensor,
                    rescale_threshold: torch.Tensor):
    """The Gbps clamps of ``ResourceGovernor.scale_verdict`` as one dense
    program: desired/pressure/quota+burst/brownout, then the rescale flag.

    ``quota_gbps`` uses +inf for "uncapped"; ``brownout`` is the base level
    (>= 1.0 means off). Unit/headroom-ledger accounting stays host-side:
    the flagged rows are the sparse set the host walks — the whole point of
    the split (O(tenants) device work, O(rescales) host work).
    """
    _count_trace("scale_decisions", est_gbps, offered_gbps, contract_gbps,
                 current_gbps, achievable_gbps, quota_gbps, credits, weights,
                 brownout, wmax, headroom, floor_frac, pressure_frac,
                 rescale_threshold)
    desired = torch.maximum(floor_frac * contract_gbps, est_gbps * headroom)
    pressure = offered_gbps > pressure_frac * achievable_gbps.clamp_min(1e-9)
    desired = torch.where(pressure,
                          torch.maximum(desired, offered_gbps * headroom),
                          desired)
    over = (desired - quota_gbps).clamp_min(0.0)
    burn = torch.minimum(over, credits.clamp_min(0.0))
    cap = torch.where(torch.isfinite(quota_gbps), quota_gbps + burn, desired)
    granted = torch.minimum(desired, cap)
    # Brownout: weight-proportional clamp toward b * contract; burst credit
    # cannot buy out a brownout (burn zeroed on clamped rows).
    bfac = brownout + (1.0 - brownout) * weights / wmax.clamp_min(1e-9)
    bfac = torch.where(brownout >= 1.0, 1.0, bfac)
    bcap = torch.maximum(floor_frac * contract_gbps, bfac * contract_gbps)
    browned = (bfac < 1.0) & (granted > bcap + _EPS)
    granted = torch.where(browned, bcap, granted)
    burn = torch.where(browned, 0.0, burn)
    gap = (granted - current_gbps).abs() / contract_gbps.clamp_min(1e-9)
    scaling_up = granted > current_gbps + 1e-9
    rescale = (scaling_up & (pressure | (gap > rescale_threshold))) \
        | (~scaling_up & (gap > rescale_threshold))
    return granted, rescale, pressure, browned, burn


def telemetry_accumulate(state, offered_gbps, achieved_gbps, backlog_pkts,
                         units, mask):
    """One fused update of the per-tenant running reduction the scalar
    ``TelemetryLog.summary`` loop performs at end of run: counts, sums for
    the means, maxes for the peaks."""
    _count_trace("telemetry_accumulate", *state, offered_gbps, achieved_gbps,
                 backlog_pkts, units, mask)
    count, s_off, s_ach, mx_back, s_units = state
    m = mask
    return (count + m,
            s_off + offered_gbps * m,
            s_ach + achieved_gbps * m,
            torch.maximum(mx_back, torch.where(m > 0, backlog_pkts,
                                               -torch.inf)),
            s_units + units * m)


def telemetry_state(n: int, device="cuda"):
    """Fresh accumulator state for ``telemetry_accumulate`` (n rows)."""
    dev = resolve_device(device)
    z = torch.zeros((n,), dtype=torch.float32, device=dev)
    return (z, z, z, torch.full((n,), -torch.inf, dtype=torch.float32,
                                device=dev), z)


# -- per-tenant reduction for TelemetryLog.summary (host-side, one-shot) -------

def telemetry_reduce_np(idx: np.ndarray, n_tenants: int,
                        means: Dict[str, np.ndarray],
                        maxes: Dict[str, np.ndarray]
                        ) -> Tuple[np.ndarray, Dict[str, np.ndarray],
                                   Dict[str, np.ndarray]]:
    """Segment-reduce per-record fields to per-tenant stats in one pass:
    ``idx`` maps each record to its tenant row. Returns (counts, per-field
    means, per-field maxes). Replaces the O(tenants x ticks) dict loops in
    ``TelemetryLog.summary`` — called once per report, numpy is the right
    backend (no reuse to amortize a device transfer against)."""
    counts = np.bincount(idx, minlength=n_tenants).astype(float)
    safe = np.maximum(counts, 1.0)
    out_means = {k: np.bincount(idx, weights=np.asarray(v, dtype=float),
                                minlength=n_tenants) / safe
                 for k, v in means.items()}
    out_maxes = {}
    for k, v in maxes.items():
        acc = np.full(n_tenants, -np.inf)
        np.maximum.at(acc, idx, np.asarray(v, dtype=float))
        out_maxes[k] = acc
    return counts, out_means, out_maxes


# -- dict-world adapter --------------------------------------------------------

class VectorizedScheduler:
    """Stateful adapter between the governor's dict world and the stacked-
    tensor kernels. Owns the persistent kernel state: row mapping (pinned
    priority order: weight descending, then name), deficits on the device,
    the ring offset, padded to pow-2 rows so churn re-pads instead of
    adding a shape key.

    ``schedule`` is a drop-in for the scalar ``dwrr_schedule`` body —
    same (order, served) contract — used when the governor runs with an
    attached kernel (``ResourceGovernor.attach_kernel``). ``device``
    defaults to the card and raises on a machine without one.
    """

    def __init__(self, max_rounds: int = 1024, device="cuda"):
        self.device = resolve_device(device)
        self.max_rounds = max_rounds
        self.names: List[str] = []
        self._row: Dict[str, int] = {}
        self._padded = 0
        self._weights = np.zeros(0, dtype=np.float32)
        self._mask = np.zeros(0, dtype=np.float32)
        self._weights_d = torch.zeros(0, device=self.device)
        self._mask_d = torch.zeros(0, device=self.device)
        self._deficits = torch.zeros(0, device=self.device)
        self._ring_offset = 0

    # -- membership ------------------------------------------------------------
    def sync(self, weights: Dict[str, float]) -> None:
        """(Re)build the row mapping when membership or weights changed.
        Deficits carry over by name; leavers are dropped (the scalar path
        forgets their deficit too)."""
        names = sorted(weights, key=lambda t: (-weights[t], t))
        if (names == self.names
                and all(np.float32(weights[t]) == self._weights[self._row[t]]
                        for t in names)):
            return
        stay = [t for t in self.names if t in weights]
        old = _to_host("sync", self._deficits) if stay else None
        old_def = {t: float(old[self._row[t]]) for t in stay}
        self.names = names
        self._row = {t: i for i, t in enumerate(names)}
        self._padded = pad_rows(len(names))
        self._weights = np.zeros(self._padded, dtype=np.float32)
        self._mask = np.zeros(self._padded, dtype=np.float32)
        for t, i in self._row.items():
            self._weights[i] = weights[t]
            self._mask[i] = 1.0
        deficits = np.zeros(self._padded, dtype=np.float32)
        for t, d in old_def.items():
            deficits[self._row[t]] = d
        rows = torch.from_numpy(np.stack([self._weights, self._mask,
                                          deficits])).to(self.device)
        self._weights_d, self._mask_d, self._deficits = rows.unbind(0)
        self._deficits = self._deficits.clone()
        self._ring_offset = 0

    def deficit(self, tenant: str) -> float:
        """Host view of a device-resident deficit (audit/debug only)."""
        i = self._row.get(tenant)
        if i is None:
            return 0.0
        return float(_to_host("deficit", self._deficits[i]))

    def deficits(self) -> Dict[str, float]:
        """Host view of every tenant's deficit in one read (audit only)."""
        if not self.names:
            return {}
        d = _to_host("deficit", self._deficits)
        return {t: float(d[i]) for t, i in self._row.items()}

    # -- the per-tick call -----------------------------------------------------
    def schedule(self, queue_bytes: Dict[str, float],
                 rate_caps: Optional[Dict[str, float]],
                 capacity_bytes: Optional[float],
                 weights: Dict[str, float],
                 max_rounds: Optional[int] = None
                 ) -> Tuple[List[str], Dict[str, float]]:
        self.sync(weights)
        n = self._padded
        # queues, caps and the budget go to the device in one copy
        host = np.zeros(2 * n + 1, dtype=np.float32)
        q, caps = host[:n], host[n:2 * n]
        caps[:] = np.inf
        for t, v in queue_bytes.items():
            i = self._row[t]
            q[i] = max(0.0, v)
            if rate_caps is not None and t in rate_caps:
                caps[i] = rate_caps[t]
        host[2 * n] = max(0.0, capacity_bytes or 0.0)
        dev = torch.from_numpy(host).to(self.device)
        q_d, caps_d, budget_d = dev[:n], dev[n:2 * n], dev[2 * n]

        if capacity_bytes is None:
            served_a, key = dwrr_uncapped(q_d, self._weights_d, caps_d,
                                          self._mask_d)
            served_np, key_np = _to_host("dwrr_uncapped",
                                         torch.stack([served_a, key]))
            order = sorted(queue_bytes,
                           key=lambda t: (-float(key_np[self._row[t]]), t))
            return order, {t: float(served_np[self._row[t]])
                           for t in queue_bytes}

        served_a, self._deficits, stamps, rounds = dwrr_step(
            q_d, self._weights_d, self._deficits, caps_d, self._mask_d,
            budget_d, self._ring_offset,
            max_rounds=max_rounds or self.max_rounds)
        self._ring_offset = (self._ring_offset + rounds) % max(
            1, len(self.names))
        # f32 served bytes and int32 stamps are exact in f64: one read
        served_np, stamps_np = _to_host(
            "dwrr_step", torch.stack([served_a.double(), stamps.double()]))
        stamped = [(int(stamps_np[self._row[t]]), t) for t in queue_bytes
                   if stamps_np[self._row[t]] >= 0]
        order = [t for _, t in sorted(stamped)]
        seen = set(order)
        # Unserved tenants trail in pinned priority order — the scalar
        # path's post-fix fill with its deterministic tie-break.
        order += [t for t in self.names if t in queue_bytes
                  and t not in seen]
        return order, {t: float(served_np[self._row[t]])
                       for t in queue_bytes}
