"""Decision-audit trace: one causally-ordered event log for the whole pool.

Every *decision* in the control plane — governor verdicts (admission /
scale / migration / failover ordering), chaos faults, gray-failure
suspicion/exoneration/quarantine transitions, recovery park/readmit — lands
here as a point event, and every controller operation (submit / scale /
migrate / failover) as a timed *span* whose begin/end events bracket
whatever nested work it caused (a mid-migration crash produces a failover
span INSIDE the migrate span). Events carry (seq, tick, tenant, nic), so an
operator question like "why was t-fw clamped at tick 412?" is one
``trace.why("t-fw", 412)`` call.

Causal order is the append order (``seq`` is a monotone counter); ticks are
stamped from whatever the runtime last ``set_tick``-ed, so layers that do
not know the tick (governor, controller) still land in the right place.

The log round-trips through JSONL (``dump_jsonl``/``load_jsonl``): a loaded
trace answers every query identically to the live one — benchmarks dump it
as a run artifact and post-mortem tests reconstruct fault stories from the
file alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

# Event kinds.
DECISION = "decision"      # a policy verdict with a reason
FAULT = "fault"            # injected fault / detector transition / recovery
SPAN = "span"              # begin/end of a timed controller operation
MARK = "mark"              # free-form annotation

# Well-known span name: the sharded controller's cross-shard
# headroom-digest refresh. ``trace.spans(name=RECONCILE)`` lists every
# reconciliation with its staleness ages and refreshed digests, and a
# ``cross_rack_placement`` decision between two reconcile spans is
# explained by the digest staleness the spans bracket.
RECONCILE = "reconcile"


@dataclasses.dataclass
class TraceEvent:
    seq: int
    tick: int
    kind: str                       # decision | fault | span | mark
    name: str                       # e.g. "scale_verdict", "gray_suspicion"
    tenant: Optional[str] = None
    nic: Optional[str] = None
    span_id: Optional[int] = None   # the span this event opens/closes
    parent_id: Optional[int] = None  # enclosing span (None = top level)
    phase: str = ""                 # "begin"/"end" for span events
    t_s: float = 0.0                # wall-clock stamp (trace clock)
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


@dataclasses.dataclass
class Span:
    """A reconstructed begin/end pair (see ``DecisionTrace.spans``)."""

    span_id: int
    name: str
    tenant: Optional[str]
    nic: Optional[str]
    parent_id: Optional[int]
    tick_begin: int
    tick_end: Optional[int]
    duration_s: Optional[float]
    detail: Dict[str, Any]
    children: List[int] = dataclasses.field(default_factory=list)


class _SpanHandle:
    """Yielded by ``span()``: lets the body attach outcome detail that lands
    on the end event (e.g. whether a migration actually committed)."""

    def __init__(self, span_id: int):
        self.span_id = span_id
        self.extra: Dict[str, Any] = {}

    def note(self, **kv: Any) -> None:
        self.extra.update(kv)


class DecisionTrace:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.events: List[TraceEvent] = []
        self.clock = clock
        self.now_tick = -1              # -1 = before the first runtime tick
        self._seq = 0
        self._next_span = 1
        self._stack: List[int] = []     # open span ids (innermost last)

    # -- recording -------------------------------------------------------------
    def set_tick(self, tick: int) -> None:
        self.now_tick = tick

    def _append(self, kind: str, name: str, tenant: Optional[str],
                nic: Optional[str], tick: Optional[int],
                span_id: Optional[int], phase: str,
                detail: Dict[str, Any]) -> TraceEvent:
        ev = TraceEvent(
            seq=self._seq,
            tick=self.now_tick if tick is None else tick,
            kind=kind, name=name, tenant=tenant, nic=nic,
            span_id=span_id,
            parent_id=self._stack[-1] if self._stack else None,
            phase=phase, t_s=self.clock(), detail=_jsonable(detail))
        self._seq += 1
        self.events.append(ev)
        return ev

    def event(self, name: str, tenant: Optional[str] = None,
              nic: Optional[str] = None, kind: str = DECISION,
              tick: Optional[int] = None, **detail: Any) -> TraceEvent:
        return self._append(kind, name, tenant, nic, tick, None, "", detail)

    @contextlib.contextmanager
    def span(self, name: str, tenant: Optional[str] = None,
             nic: Optional[str] = None, tick: Optional[int] = None,
             **detail: Any) -> Iterator[_SpanHandle]:
        sid = self._next_span
        self._next_span += 1
        begin = self._append(SPAN, name, tenant, nic, tick, sid, "begin",
                             detail)
        handle = _SpanHandle(sid)
        self._stack.append(sid)
        try:
            yield handle
        finally:
            self._stack.pop()
            # parent_id of the end event = the span itself being closed is
            # not on the stack anymore; keep the begin's parent for symmetry.
            end = TraceEvent(
                seq=self._seq, tick=self.now_tick if tick is None else tick,
                kind=SPAN, name=name, tenant=tenant, nic=nic, span_id=sid,
                parent_id=begin.parent_id, phase="end", t_s=self.clock(),
                detail=_jsonable({**detail, **handle.extra,
                                  "duration_s": self.clock() - begin.t_s}))
            self._seq += 1
            self.events.append(end)

    # -- queries ---------------------------------------------------------------
    def query(self, name: Optional[str] = None, tenant: Optional[str] = None,
              nic: Optional[str] = None, tick: Optional[int] = None,
              kind: Optional[str] = None, since: Optional[int] = None,
              until: Optional[int] = None) -> List[TraceEvent]:
        """Filter the log (None = wildcard); result is in causal order."""
        out = []
        for e in self.events:
            if name is not None and e.name != name:
                continue
            if tenant is not None and e.tenant != tenant:
                continue
            if nic is not None and e.nic != nic:
                continue
            if tick is not None and e.tick != tick:
                continue
            if kind is not None and e.kind != kind:
                continue
            if since is not None and e.tick < since:
                continue
            if until is not None and e.tick > until:
                continue
            out.append(e)
        return out

    def why(self, tenant: str, tick: Optional[int] = None, *,
            tick_lo: Optional[int] = None,
            tick_hi: Optional[int] = None) -> List[TraceEvent]:
        """Every decision/fault/span event touching ``tenant`` at ``tick``
        (or within ``[tick_lo, tick_hi]``) — the audit answer to "why did
        the pool do that to this tenant?".

        The range form is *span-closed*: if either half of a
        begin/end span pair lands in the window, its partner is included
        too, so a burn-window query never returns a dangling span. Result
        stays in causal (seq) order."""
        if tick is not None:
            tick_lo = tick_hi = tick
        lo = tick_lo if tick_lo is not None else float("-inf")
        hi = tick_hi if tick_hi is not None else float("inf")
        sel = [e for e in self.events
               if e.tenant == tenant and lo <= e.tick <= hi]
        sids = {e.span_id for e in sel
                if e.kind == SPAN and e.span_id is not None}
        if sids:
            have = {e.seq for e in sel}
            closers = [e for e in self.events
                       if e.kind == SPAN and e.span_id in sids
                       and e.seq not in have]
            if closers:
                sel = sorted(sel + closers, key=lambda e: e.seq)
        return sel

    def spans(self, name: Optional[str] = None,
              tenant: Optional[str] = None) -> List[Span]:
        """Reconstruct spans from begin/end pairs, children linked by
        ``parent_id``. Unclosed spans have tick_end/duration None."""
        by_id: Dict[int, Span] = {}
        for e in self.events:
            if e.kind != SPAN:
                continue
            if e.phase == "begin":
                by_id[e.span_id] = Span(
                    span_id=e.span_id, name=e.name, tenant=e.tenant,
                    nic=e.nic, parent_id=e.parent_id, tick_begin=e.tick,
                    tick_end=None, duration_s=None, detail=dict(e.detail))
            elif e.phase == "end" and e.span_id in by_id:
                sp = by_id[e.span_id]
                sp.tick_end = e.tick
                sp.duration_s = e.detail.get("duration_s")
                sp.detail.update(e.detail)
        for sp in by_id.values():
            if sp.parent_id in by_id:
                by_id[sp.parent_id].children.append(sp.span_id)
        out = [sp for sp in by_id.values()
               if (name is None or sp.name == name)
               and (tenant is None or sp.tenant == tenant)]
        return sorted(out, key=lambda s: s.span_id)

    # -- JSONL round trip ------------------------------------------------------
    def dump_jsonl(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            for e in self.events:
                f.write(e.to_json() + "\n")

    @classmethod
    def load_jsonl(cls, path) -> "DecisionTrace":
        trace = cls()
        with pathlib.Path(path).open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                trace.events.append(TraceEvent(**d))
        if trace.events:
            trace._seq = max(e.seq for e in trace.events) + 1
            trace._next_span = max(
                (e.span_id for e in trace.events if e.span_id is not None),
                default=0) + 1
        return trace


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce detail values to JSON-stable forms (sets/tuples -> lists)."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, (set, frozenset)):
            out[k] = sorted(v)
        elif isinstance(v, tuple):
            out[k] = list(v)
        elif hasattr(v, "item"):            # numpy scalar
            out[k] = v.item()
        else:
            out[k] = v
    return out
