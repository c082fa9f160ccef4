"""Control-plane flight recorder: correlated events — the port of
``horovod_tpu/observe/events.py``.

Every lifecycle actor emits structured events through one API::

    from horovod_tpu_torch.observe import events
    eid = events.record_event("abort.publish", severity="critical",
                              payload={"reason": ...},
                              cause_id=lease_expiry_id)

Each event is ``{id, ts, host, rank, kind, severity, correlation_id,
cause_id, payload}`` with ids ``<host>-<pid>-<seq>``.  ``cause_id``
links events into causal chains (abort flag → restart → ...);
``correlation_id`` names the whole incident — it is inherited from the
cause when one is known (even across processes, via ids carried in
abort flags) and is the event's own id at a chain root.

Transport: events append to a bounded per-process ring (overflow drops
the oldest and counts ``hvd_events_dropped_total`` — the recorder must
never block a step).  In the launcher process the recorder is attached
directly to the :class:`~horovod_tpu_torch.run.http_server.RendezvousServer`
(``attach_server``) and each event lands in the journaled ``events``
scope immediately — surviving warm-standby failover like membership
does.  In worker processes a flusher thread (modeled on
metrics/push.py) drains the ring through the relay/batch path
(run/relay.py: ``events`` is a batch scope — every event has a unique
key, so last-writer-wins coalescing can never merge two distinct
events) with permanent fallback to the primary when the relay dies.

Consumers: signed ``GET /events`` with cursor reads
(``scope_since("events", v)``).  Knobs:
``HVD_EVENTS`` / ``HVD_EVENTS_RING_CAP`` / ``HVD_EVENTS_FLUSH_SECONDS``
/ ``HVD_EVENTS_SERVER_CAP`` (docs/observe.md).
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

#: rendezvous KV scope the recorder flushes into (journaled, cursor-read)
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
    """One process's flight-recorder state: the bounded ring, the
    id → correlation map that threads chains, and whichever sink
    (in-process server or relay-routed flusher) drains it."""

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
        self._server = None  # attached RendezvousServer (launcher)
        self._direct_puts = 0
        self._flusher: Optional["EventFlusher"] = None

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
            server = self._server
        _record_metric("EVENTS_TOTAL", (kind, severity))
        if dropped:
            _record_metric("EVENTS_DROPPED")
        if server is not None:
            self._drain_to_server(server)
        return eid

    # -- sinks ------------------------------------------------------------
    def attach_server(self, server) -> None:
        """Launcher-side sink: events land in the server's journaled
        ``events`` scope immediately (no flusher thread, no HTTP)."""
        self._server = server
        if server is not None:
            self._drain_to_server(server)

    def _drain_to_server(self, server) -> None:
        for event in self.drain():
            try:
                server.put(EVENTS_SCOPE, event["id"],
                           json.dumps(event).encode())
                self._direct_puts += 1
            except Exception as e:  # noqa: BLE001 — recording is best-effort
                log.debug("event put failed: %s", e)
        # bound the server-side scope so an always-on recorder cannot
        # grow the store (and its journal replay) without limit
        if self._direct_puts and self._direct_puts % 512 == 0:
            try:
                prune_scope(server)
            except Exception:  # noqa: BLE001
                pass

    def drain(self) -> List[dict]:
        """Pop every buffered event (flusher / attached-server sink)."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def requeue(self, events: List[dict]) -> None:
        """Put undelivered events back at the front for the next flush
        (newer appends win the ring slots if it overflows)."""
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


def prune_scope(server, cap: Optional[int] = None) -> int:
    """Trim the server's ``events`` scope to the newest ``cap`` events
    (``HVD_EVENTS_SERVER_CAP``); returns how many were dropped."""
    cap = int(cap if cap is not None else env_util.get_int(
        env_util.HVD_EVENTS_SERVER_CAP,
        env_util.DEFAULT_EVENTS_SERVER_CAP))
    items = server.scope_items(EVENTS_SCOPE)
    if len(items) <= cap:
        return 0
    def _ts(kv):
        try:
            return float(json.loads(kv[1]).get("ts") or 0.0)
        except (ValueError, TypeError):
            return 0.0
    excess = sorted(items.items(), key=_ts)[:len(items) - cap]
    for key, _ in excess:
        server.delete(EVENTS_SCOPE, key)
    return len(excess)


class EventFlusher:
    """Worker-side flusher thread (metrics/push.py template): drains the
    ring every ``HVD_EVENTS_FLUSH_SECONDS`` through the relay when one
    is resolved — each event is one loopback PUT the relay coalesces
    into its upstream batch — with permanent fallback to the primary
    (``mark_relay_failed``) when the relay dies; the direct path ships
    the whole drain as one signed ``PUT /batch``.  Never raises."""

    def __init__(self, recorder: Recorder, addr: str, port: int,
                 secret: Optional[bytes] = None,
                 interval: Optional[float] = None):
        self.recorder = recorder
        self.addr = addr
        self.port = int(port)
        self.secret = secret
        self.interval = float(interval if interval is not None
                              else env_util.get_float(
                                  env_util.HVD_EVENTS_FLUSH_SECONDS,
                                  env_util.get_float(
                                      env_util.HVD_METRICS_PUSH_SECONDS,
                                      env_util.DEFAULT_EVENTS_FLUSH_SECONDS)))
        self.flushes = 0
        self.events_flushed = 0
        self.errors = 0
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def flush_now(self) -> bool:
        events = self.recorder.drain()
        if not events:
            return True
        from ..run import relay as relay_mod
        from ..run.http_client import put_batch

        try:
            ep = relay_mod.control_endpoint()
            if ep is not None and ep[2]:
                # relay path: loopback PUTs the relay batches upstream;
                # control_put flips to the direct path permanently on a
                # dead relay, so no event is silently lost behind one
                for event in events:
                    relay_mod.control_put(
                        self.addr, self.port, EVENTS_SCOPE, event["id"],
                        json.dumps(event).encode(), secret=self.secret)
            else:
                put_batch(self.addr, self.port,
                          [(f"/{EVENTS_SCOPE}/{e['id']}",
                            json.dumps(e).encode()) for e in events],
                          secret=self.secret, retry=True)
        except Exception as e:  # noqa: BLE001 — keep them for next flush
            self.errors += 1
            log.debug("event flush failed (%d kept): %s", len(events), e)
            self.recorder.requeue(events)
            return False
        self.flushes += 1
        self.events_flushed += len(events)
        return True

    def _loop(self) -> None:
        while not self._stop_event.wait(self.interval):
            self.flush_now()
        self.flush_now()  # final drain

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-events-flush")
        self._thread.start()
        atexit.register(self.stop)

    def stop(self, final_flush: bool = True) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_flush:
            self.flush_now()


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
    or None when the recorder is off (callers embed the id in flags /
    epoch records; None serializes harmlessly)."""
    if not on():
        return None
    rec = recorder()
    eid = rec.record(kind, severity=severity, payload=payload,
                     correlation_id=correlation_id, cause_id=cause_id,
                     rank=rank)
    if rec._server is None and rec._flusher is None:
        _maybe_start_flusher(rec)
    return eid


def _maybe_start_flusher(rec: Recorder) -> None:
    """Lazily start the worker-side flusher the first time an event is
    recorded in a process with rendezvous wiring but no attached
    server (workers; the launcher attaches directly)."""
    with _recorder_lock:
        if rec._flusher is not None or rec._server is not None:
            return
        addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
        port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
        if not addr or not port:
            return
        secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
        secret = bytes.fromhex(secret_hex) if secret_hex else None
        rec._flusher = EventFlusher(rec, addr, port, secret=secret)
        rec._flusher.start()


def attach_server(server) -> None:
    """Wire the launcher's recorder straight into its rendezvous server
    (run/run.py launch_job)."""
    if on():
        recorder().attach_server(server)


def flush() -> None:
    """Force a synchronous drain (tests, shutdown paths)."""
    rec = _recorder
    if rec is None:
        return
    if rec._server is not None:
        rec._drain_to_server(rec._server)
    elif rec._flusher is not None:
        rec._flusher.flush_now()


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
        if _recorder is not None and _recorder._flusher is not None:
            _recorder._flusher.stop(final_flush=False)
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
