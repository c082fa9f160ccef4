"""System invariant monitors: machine-checked recovery promises — the
port of ``horovod_tpu/observe/invariants.py``.

Every fault-tolerance subsystem in this repo makes a promise — epochs
only move forward, aborts reach survivors within a bounded delay, a
lossy recovery costs at most one snapshot interval, ranks restoring
from peers agree on the source generation, a drained serving replica
completes each request exactly once, and nobody is left in the roster
without being live.  Until now those promises were each pinned by one
unit test; nothing checked them *as a system* while composed failures
were in flight.

This module turns each promise into an :class:`Invariant` evaluated
over the flight-recorder event stream (``GET /events``,
observe/events.py) plus optional side evidence (final worker statuses
from the chaos runner, serving completion counts).  A failed check
yields a :class:`Violation` carrying the **causal event chain** as
evidence — the same ``cause_id``/``correlation_id`` walk the incident
console uses (events.extract_chain) — so a red verdict always names
the exact sequence of control-plane actions that broke the promise.

Consumed by the chaos fixture (observe/fixtures.py ``chaos_fixture``)
and directly against a live job's event stream (the checkers only need
the event dicts).

The catalogue:

===========================  ============================================
invariant                    promise
===========================  ============================================
``epoch-monotonic``          committed epochs strictly increase; no two
                             commits share an epoch number (fencing)
``abort-propagation``        every abort is observed by at least one
                             survivor within 2 x the heartbeat interval
``steps-lost-bound``         a resume loses at most one snapshot
                             interval of steps
``restore-source-agreement`` every rank restoring into the same epoch
                             restores from the same snapshot generation
``serving-exactly-once``     no request id completes twice
``no-hanging-rank``          at quiescence, every roster member is live
                             and every non-member has actually stopped
===========================  ============================================
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..utils.logging import get_logger
from .events import extract_chain

log = get_logger(__name__)


@dataclass
class Violation:
    """One broken promise, with its causal evidence."""

    invariant: str
    message: str
    chain: List[dict] = field(default_factory=list)
    evidence: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "invariant": self.invariant,
            "message": self.message,
            "evidence": self.evidence,
            "chain": [{k: e.get(k) for k in
                       ("ts", "kind", "severity", "rank", "id")}
                      for e in self.chain],
        }


@dataclass
class Context:
    """The evidence bundle one check run sees.

    ``events``: flight-recorder events, any order (checks sort).
    ``hb_interval``: the heartbeat interval the run used, seconds.
    ``snapshot_every``: the snapshot commit cadence, steps.
    ``workers``: optional final worker statuses from the chaos runner —
    ``{worker_id: {"status": ..., "step": ...}}``; statuses in
    ``LIVE_END_STATES`` count as a clean end.
    ``final_world``: optional final committed roster.
    ``serving``: optional serving evidence —
    ``{"completed": {request_id: count}}``.
    """

    events: List[dict]
    hb_interval: float = 2.0
    snapshot_every: int = 5
    workers: Optional[Dict[str, dict]] = None
    final_world: Optional[List[str]] = None
    serving: Optional[Dict[str, object]] = None

    def sorted_events(self) -> List[dict]:
        return sorted((e for e in self.events if isinstance(e, dict)),
                      key=lambda e: (e.get("ts") or 0.0,
                                     str(e.get("id"))))

    def of_kind(self, kind: str) -> List[dict]:
        return [e for e in self.sorted_events() if e.get("kind") == kind]

    def chain(self, event: dict) -> List[dict]:
        eid = event.get("id")
        return extract_chain(self.events, eid) if eid else [event]


#: a worker whose scenario ended in one of these states is accounted
#: for; anything else still in the roster is a hanging rank
LIVE_END_STATES = ("running", "finished", "drained", "preempted")


def check_epoch_monotonic(ctx: Context) -> List[Violation]:
    """Commits must strictly increase — a repeated or regressing epoch
    number means the single-writer fence broke (split-brain driver or
    a standby takeover that rolled the world back)."""
    out: List[Violation] = []
    last: Optional[int] = None
    last_event: Optional[dict] = None
    for e in ctx.of_kind("epoch.commit"):
        epoch = (e.get("payload") or {}).get("epoch")
        if epoch is None:
            continue
        if last is not None and epoch <= last:
            out.append(Violation(
                invariant="epoch-monotonic",
                message=(f"epoch.commit regressed or repeated: epoch "
                         f"{epoch} committed after epoch {last}"),
                chain=ctx.chain(e),
                evidence={"epoch": epoch, "previous": last,
                          "previous_event": (last_event or {}).get("id")}))
        last, last_event = epoch, e
    return out


def check_abort_propagation(ctx: Context) -> List[Violation]:
    """Every ``abort.publish`` must gather at least one survivor
    ``abort.observe`` within 2 x the heartbeat interval — the detect →
    propagate promise.  A publish whose next
    commit left no survivors (give-up, world of one) is exempt."""
    out: List[Violation] = []
    bound = 2.0 * ctx.hb_interval
    observes_by_cause: Dict[str, List[dict]] = {}
    for o in ctx.of_kind("abort.observe"):
        cause = o.get("cause_id")
        if cause:
            observes_by_cause.setdefault(cause, []).append(o)
    commits = ctx.of_kind("epoch.commit")
    for p in ctx.of_kind("abort.publish"):
        observes = observes_by_cause.get(p.get("id"), [])
        late = [o for o in observes
                if (o.get("ts") or 0.0) - (p.get("ts") or 0.0) > bound]
        for o in late:
            out.append(Violation(
                invariant="abort-propagation",
                message=(f"abort observed {((o.get('ts') or 0.0) - (p.get('ts') or 0.0)) * 1000:.0f}ms "
                         f"after publish (bound {bound * 1000:.0f}ms, "
                         f"2 x {ctx.hb_interval * 1000:.0f}ms heartbeat)"),
                chain=ctx.chain(o),
                evidence={"publish": p.get("id"), "observe": o.get("id"),
                          "bound_ms": bound * 1000}))
        if not observes:
            # exempt when no survivor could observe: the commit that
            # followed this publish kept nobody from the old world
            nxt = next((c for c in commits
                        if (c.get("ts") or 0.0) >= (p.get("ts") or 0.0)
                        and (c.get("payload") or {}).get("size")), None)
            if nxt is not None and (nxt.get("payload") or {}).get(
                    "size", 0) > 0:
                out.append(Violation(
                    invariant="abort-propagation",
                    message=("abort.publish was never observed by any "
                             "survivor although the next epoch has "
                             f"{(nxt.get('payload') or {}).get('size')} "
                             "member(s)"),
                    chain=ctx.chain(p),
                    evidence={"publish": p.get("id"),
                              "next_commit": nxt.get("id")}))
    return out


def check_steps_lost_bound(ctx: Context) -> List[Violation]:
    """Every ``restart.resume`` must report ``steps_lost`` of at most
    one snapshot interval — the recovery-cost promise of the peer state
    plane (a lossy removal rolls survivors back to the newest committed
    snapshot, never further)."""
    out: List[Violation] = []
    for e in ctx.of_kind("restart.resume"):
        lost = (e.get("payload") or {}).get("steps_lost")
        if lost is None:
            continue
        if lost > ctx.snapshot_every:
            out.append(Violation(
                invariant="steps-lost-bound",
                message=(f"rank {e.get('rank')} lost {lost} steps on "
                         f"resume — more than one snapshot interval "
                         f"({ctx.snapshot_every})"),
                chain=ctx.chain(e),
                evidence={"steps_lost": lost,
                          "snapshot_every": ctx.snapshot_every,
                          "resume": e.get("id")}))
    return out


def check_restore_source_agreement(ctx: Context) -> List[Violation]:
    """All ``restore.source`` events for the same epoch must name the
    same snapshot generation — ranks restoring from different
    generations silently diverge (the collective-agreement
    promise)."""
    out: List[Violation] = []
    by_epoch: Dict[int, List[dict]] = {}
    for e in ctx.of_kind("restore.source"):
        epoch = (e.get("payload") or {}).get("epoch")
        if epoch is not None:
            by_epoch.setdefault(int(epoch), []).append(e)
    for epoch, group in sorted(by_epoch.items()):
        gens = {(e.get("payload") or {}).get("gen") for e in group}
        if len(gens) > 1:
            out.append(Violation(
                invariant="restore-source-agreement",
                message=(f"epoch {epoch}: ranks restored from "
                         f"disagreeing snapshot generations "
                         f"{sorted(gens, key=str)}"),
                chain=ctx.chain(group[0]),
                evidence={"epoch": epoch,
                          "generations": sorted(gens, key=str),
                          "events": [e.get("id") for e in group]}))
    return out


def check_serving_exactly_once(ctx: Context) -> List[Violation]:
    """No request id completes twice — across drains, requeues, and
    replica removals.  Evaluated over ``serve.complete`` events and/or
    the ``ctx.serving`` completion counts; passes vacuously when a run
    produced neither (training-only scenarios)."""
    out: List[Violation] = []
    counts: Dict[str, int] = {}
    first_event: Dict[str, dict] = {}
    for e in ctx.of_kind("serve.complete"):
        rid = (e.get("payload") or {}).get("request_id")
        if rid is None:
            continue
        rid = str(rid)
        counts[rid] = counts.get(rid, 0) + 1
        first_event.setdefault(rid, e)
    for rid, n in ((r, c) for r, c in
                   ((ctx.serving or {}).get("completed") or {}).items()):
        counts[str(rid)] = max(counts.get(str(rid), 0), int(n))
    for rid, n in sorted(counts.items()):
        if n > 1:
            e = first_event.get(rid)
            out.append(Violation(
                invariant="serving-exactly-once",
                message=f"request {rid} completed {n} times",
                chain=ctx.chain(e) if e else [],
                evidence={"request_id": rid, "completions": n}))
    return out


def check_no_hanging_rank(ctx: Context) -> List[Violation]:
    """At quiescence, every member of the final world must be live and
    every worker that is NOT live must be out of the world — a crashed,
    hung, or partitioned rank still in the roster means detection or
    removal never finished.  Needs runner evidence (``ctx.workers`` +
    ``ctx.final_world``); passes vacuously on a pure event stream."""
    if ctx.workers is None or ctx.final_world is None:
        return []
    out: List[Violation] = []
    for wid, info in sorted(ctx.workers.items()):
        status = (info or {}).get("status", "unknown")
        if wid in ctx.final_world and status not in LIVE_END_STATES:
            removes = [e for e in ctx.of_kind("epoch.remove")
                       if (e.get("payload") or {}).get("worker") == wid]
            out.append(Violation(
                invariant="no-hanging-rank",
                message=(f"worker {wid} ended {status!r} but is still "
                         f"in the committed world {ctx.final_world}"),
                chain=ctx.chain(removes[-1]) if removes else [],
                evidence={"worker": wid, "status": status,
                          "final_world": list(ctx.final_world)}))
    return out


#: name → checker; the catalogue the CLI and docs render
INVARIANTS: Dict[str, Callable[[Context], List[Violation]]] = {
    "epoch-monotonic": check_epoch_monotonic,
    "abort-propagation": check_abort_propagation,
    "steps-lost-bound": check_steps_lost_bound,
    "restore-source-agreement": check_restore_source_agreement,
    "serving-exactly-once": check_serving_exactly_once,
    "no-hanging-rank": check_no_hanging_rank,
}


def check_all(events: List[dict], *, hb_interval: float = 2.0,
              snapshot_every: int = 5,
              workers: Optional[Dict[str, dict]] = None,
              final_world: Optional[List[str]] = None,
              serving: Optional[Dict[str, object]] = None,
              only: Optional[List[str]] = None) -> List[Violation]:
    """Run the catalogue (or the ``only`` subset) over one evidence
    bundle; returns every violation, stable-ordered by the catalogue."""
    ctx = Context(events=events, hb_interval=hb_interval,
                  snapshot_every=snapshot_every, workers=workers,
                  final_world=final_world, serving=serving)
    out: List[Violation] = []
    for name, checker in INVARIANTS.items():
        if only is not None and name not in only:
            continue
        try:
            out.extend(checker(ctx))
        except Exception:  # noqa: BLE001 — one broken checker must not
            log.exception("invariant checker %s failed", name)  # mask
            out.append(Violation(                               # others
                invariant=name,
                message=f"checker {name} raised (see launcher log)"))
    return out


def format_violation(v: Violation) -> str:
    """The console rendering: verdict line plus the causal chain,
    oldest first."""
    lines = [f"VIOLATION [{v.invariant}] {v.message}"]
    if v.evidence:
        lines.append("  evidence: " + ", ".join(
            f"{k}={v.evidence[k]}" for k in sorted(v.evidence)))
    if v.chain:
        t0 = v.chain[0].get("ts") or 0.0
        lines.append("  causal chain:")
        for e in v.chain:
            rank = e.get("rank")
            lines.append(
                f"    +{((e.get('ts') or 0.0) - t0) * 1000:7.0f}ms "
                f"{e.get('severity', 'info'):8s} {e.get('kind')}"
                + (f" rank={rank}" if rank is not None else ""))
    return "\n".join(lines)
