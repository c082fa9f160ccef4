"""Control-plane flight recorder: correlated events — the local half of
``horovod_tpu/observe/events.py``.

Every lifecycle actor emits structured events through one API::

    from horovod_tpu_torch.observe import events
    eid = events.record_event("compression.fallback", severity="warning",
                              payload={"residual_norm": ...})

Each event is ``{id, ts, host, rank, kind, severity, correlation_id,
cause_id, payload}`` with ids ``<host>-<pid>-<seq>``.  ``cause_id``
links events into causal chains; ``correlation_id`` names the whole
incident — inherited from the cause when this process recorded it, and
the event's own id at a chain root.  Events append to a bounded
per-process ring (overflow drops the oldest and counts
``hvd_events_dropped_total``; the recorder never blocks a step).

The sinks that drain the ring into the launcher's journaled ``events``
scope (``attach_server``, the worker-side flusher, ``PUT /batch``) need
the rendezvous server, which the port does not have yet: asking for
them raises.  Knobs: ``HVD_EVENTS``, ``HVD_EVENTS_RING_CAP``.
"""

from __future__ import annotations

import collections
import itertools
import os
import socket
import threading
import time
from typing import Dict, List, Optional

from ..utils import env as env_util

#: rendezvous KV scope the reference's recorder flushes into
EVENTS_SCOPE = "events"

#: kinds are dotted "<subsystem>.<action>" names; the inventory below is
#: documentation, not an enum — emitters may add new kinds freely
KNOWN_KINDS = (
    "epoch.commit", "epoch.remove", "epoch.admit", "epoch.drain",
    "epoch.drain_ack", "epoch.blocklist", "epoch.giveup",
    "lease.expired", "abort.publish", "abort.observe",
    "restart.attempt", "restart.resume",
    "autoscale.grow", "autoscale.shrink",
    "autotune.apply", "autotune.verify", "autotune.rollback",
    "compression.fallback",
    "checkpoint.save", "checkpoint.commit", "checkpoint.restore",
    "snapshot.begin", "snapshot.commit", "snapshot.reprotect",
    "restore.source", "spare.purged",
    "watchdog.alert", "watchdog.arm",
    "preempt.notice", "primary.takeover", "chaos.inject",
)


def _record_metric(name: str, labels=None, n: int = 1) -> None:
    """Count on the metrics plane; never raises (the recorder must not
    take down the caller)."""
    try:
        from .. import metrics

        if metrics.on():
            fam = getattr(metrics, name)
            (fam.labels(*labels) if labels else fam).inc(n)
    except Exception:  # noqa: BLE001
        pass


class Recorder:
    """One process's flight-recorder state: the bounded ring and the
    id → correlation map that threads chains."""

    def __init__(self, cap: Optional[int] = None):
        self.cap = int(cap if cap is not None else env_util.get_int(
            env_util.HVD_EVENTS_RING_CAP,
            env_util.DEFAULT_EVENTS_RING_CAP))
        self._ring: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._host = socket.gethostname() or "localhost"
        self._pid = os.getpid()
        # id → correlation_id for events THIS process recorded, so a
        # same-process cause resolves its chain without a server round
        # trip; bounded like the ring
        self._corr: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self.dropped = 0
        self.recorded = 0

    # -- the hot path -----------------------------------------------------
    def record(self, kind: str, severity: str = "info",
               payload: Optional[dict] = None,
               correlation_id: Optional[str] = None,
               cause_id: Optional[str] = None,
               rank: Optional[int] = None) -> str:
        """Append one event; returns its id (the handle callers embed in
        flags/records so downstream actors can chain onto it).  A dict
        build + deque append — target <1% of a 1 ms step."""
        eid = f"{self._host}-{self._pid}-{next(self._seq)}"
        if correlation_id is None:
            if cause_id is not None:
                correlation_id = self._corr.get(cause_id, cause_id)
            else:
                correlation_id = eid
        event = {
            "id": eid,
            "ts": time.time(),
            "host": self._host,
            "rank": rank,
            "kind": kind,
            "severity": severity,
            "correlation_id": correlation_id,
            "cause_id": cause_id,
            "payload": payload or {},
        }
        with self._lock:
            self._corr[eid] = correlation_id
            while len(self._corr) > 4 * self.cap:
                self._corr.popitem(last=False)
            self._ring.append(event)
            if len(self._ring) > self.cap:
                self._ring.popleft()
                self.dropped += 1
                dropped = True
            else:
                dropped = False
            self.recorded += 1
        _record_metric("EVENTS_TOTAL", (kind, severity))
        if dropped:
            _record_metric("EVENTS_DROPPED")
        return eid

    def drain(self) -> List[dict]:
        """Pop every buffered event."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def requeue(self, events: List[dict]) -> None:
        """Put undrained events back at the front of the ring (newer
        appends win the ring slots if it overflows)."""
        with self._lock:
            for event in reversed(events):
                self._ring.appendleft(event)
            while len(self._ring) > self.cap:
                self._ring.pop()
                self.dropped += 1
                _record_metric("EVENTS_DROPPED")

    def pending(self) -> int:
        with self._lock:
            return len(self._ring)


# ---------------------------------------------------------------------------
# process-wide surface
# ---------------------------------------------------------------------------
_recorder: Optional[Recorder] = None
_recorder_lock = threading.Lock()


def on() -> bool:
    return env_util.get_bool(env_util.HVD_EVENTS, True)


def recorder() -> Recorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = Recorder()
    return _recorder


def record_event(kind: str, severity: str = "info",
                 payload: Optional[dict] = None,
                 correlation_id: Optional[str] = None,
                 cause_id: Optional[str] = None,
                 rank: Optional[int] = None) -> Optional[str]:
    """The one emission API (module docstring).  Returns the event id,
    or None when the recorder is off.  Raises when the environment names
    the rendezvous server, whose flusher is not ported yet."""
    if not on():
        return None
    from .. import metrics

    if metrics.rendezvous_requested():
        metrics.refuse_rendezvous("the flight recorder's flusher "
                                  "(observe/events.py)")
    return recorder().record(kind, severity=severity, payload=payload,
                             correlation_id=correlation_id,
                             cause_id=cause_id, rank=rank)


def attach_server(server) -> None:
    """The reference's launcher-side sink: refused (not ported yet)."""
    del server
    from .. import metrics

    metrics.refuse_rendezvous("attaching the flight recorder to a "
                              "rendezvous server")


def correlation_of(event_id: Optional[str]) -> Optional[str]:
    """The correlation id of an event THIS process recorded (None when
    unknown) — emitters embed it next to the event id in flags/records
    so downstream processes join the same chain."""
    if event_id is None or _recorder is None:
        return None
    with _recorder._lock:
        return _recorder._corr.get(event_id)


def _reset_for_tests() -> None:
    global _recorder
    with _recorder_lock:
        _recorder = None


# ---------------------------------------------------------------------------
# chain extraction (shared by hvd_events --chain, hvd_dash --incident,
# and the e2e causal-chain test)
# ---------------------------------------------------------------------------
def extract_chain(events: List[dict], event_id: str) -> List[dict]:
    """The causal chain an event belongs to: walk ``cause_id`` links to
    the root, then return every event sharing the root's correlation id
    (plus any linked by cause into the chain), oldest first."""
    by_id = {e.get("id"): e for e in events if isinstance(e, dict)}
    node = by_id.get(event_id)
    if node is None:
        return []
    seen = set()
    while node.get("cause_id") in by_id and node["id"] not in seen:
        seen.add(node["id"])
        node = by_id[node["cause_id"]]
    corr = node.get("correlation_id") or node.get("id")
    chain = [e for e in events if isinstance(e, dict)
             and (e.get("correlation_id") == corr or e.get("id") == corr)]
    chain.sort(key=lambda e: (e.get("ts") or 0.0, str(e.get("id"))))
    return chain


def chain_summary(chain: List[dict]) -> Dict[str, object]:
    """The incident-report digest of a chain: what failed, what the
    control plane did, and what it cost (hvd_dash --incident)."""
    kinds = [e.get("kind") for e in chain]
    failed_rank = None
    steps_lost = None
    for e in chain:
        p = e.get("payload") or {}
        if failed_rank is None:
            failed_rank = p.get("rank") if e.get("kind") in (
                "lease.expired", "epoch.remove") else failed_rank
            if failed_rank is None and e.get("kind") == "lease.expired":
                failed_rank = e.get("rank")
        if e.get("kind") == "restart.resume" and \
                p.get("steps_lost") is not None:
            steps_lost = p.get("steps_lost")
    duration = None
    if len(chain) >= 2:
        ts = [e.get("ts") for e in chain if e.get("ts") is not None]
        if len(ts) >= 2:
            duration = max(ts) - min(ts)
    return {
        "correlation_id": chain[0].get("correlation_id") if chain else None,
        "events": len(chain),
        "kinds": kinds,
        "failed_rank": failed_rank,
        "steps_lost": steps_lost,
        "duration_seconds": duration,
        "severities": sorted({e.get("severity") for e in chain
                              if e.get("severity")}),
    }
