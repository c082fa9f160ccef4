"""Coordinated abort: one job-wide flag instead of N hanging ranks — the
port of ``horovod_tpu/elastic/abort.py``.

The reference's only reaction to a wedged rank is per-rank: the stall
inspector warns, then ``HOROVOD_STALL_SHUTDOWN`` hard-exits *that* rank
(reference stall_inspector.h:42) — and every other rank keeps blocking in
its next collective until a transport timeout, with no root cause in any
log.  Here the failure domain is the *job*: a single abort flag lives on
the launcher's rendezvous KV store (run/http_server.py ``abort`` scope),
set by whichever plane notices the failure first —

* the launcher's supervision loop, on a worker death (run/run.py);
* the stall inspector's shutdown path (runtime/stall_inspector.py);
* any rank, via :func:`abort` (application code that detects an
  unrecoverable condition, e.g. the sanitizer's divergence handler).

Each rank's heartbeat thread (elastic/heartbeat.py) polls the flag every
lease interval; the next eager dispatch or train-step raises
:class:`HorovodAbortError` naming the dead/diverging rank and the reason,
so surviving ranks exit in seconds with a diagnosis instead of hanging
until a collective timeout.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from ..run.http_server import ABORT_KEY, ABORT_SCOPE  # noqa: F401 — the
#   wire constants live with the server (single source of truth for the
#   /abort/flag key); re-exported here for the runtime side
from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)


class HorovodAbortError(RuntimeError):
    """The job was aborted by the coordinated-abort protocol.  The message
    names the source plane, the failing rank (when known), and the reason
    recorded by whoever set the flag."""


def format_abort(info: dict) -> str:
    who = info.get("rank")
    src = info.get("source", "unknown")
    epoch = info.get("epoch")
    parts = [f"reported by {src}"]
    if who is not None:
        parts.append(f"failing rank {who}")
    if epoch is not None:
        parts.append(f"membership epoch {epoch}")
    where = f" ({', '.join(parts)})"
    return f"coordinated abort: {info.get('reason', '<no reason>')}{where}"


def _rendezvous_from_env():
    """(addr, port, secret) of the launcher's rendezvous server, from the
    same wiring the metrics pusher and sanitizer ride — or None when this
    process was not launched under the launcher / run()."""
    addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
    port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
    if not addr or not port:
        return None
    secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
    secret = bytes.fromhex(secret_hex) if secret_hex else None
    return addr, port, secret


def make_flag(reason: str, *, rank: Optional[int] = None,
              source: str = "api", epoch: Optional[int] = None) -> dict:
    """``epoch`` scopes the flag to one membership epoch: the elastic
    driver stamps the epoch it is aborting, and heartbeats of a LATER
    epoch ignore the flag (a survivor that already rebuilt must not be
    re-aborted by the stale flag of the world it just left).  ``None``
    (the launcher/stall/api flags) is honored by every epoch."""
    if rank is None:
        rank = env_util.get_int(env_util.HVD_PROCESS_ID, -1)
        rank = rank if rank >= 0 else None
    flag = {
        "reason": str(reason),
        "rank": rank,
        "source": source,
        "pid": os.getpid(),
        "time": time.time(),
    }
    if epoch is not None:
        flag["epoch"] = int(epoch)
    return flag


def publish(flag: dict, *, addr: Optional[str] = None,
            port: Optional[int] = None, secret: Optional[bytes] = None,
            timeout: float = 10.0) -> bool:
    """Publish one prebuilt abort flag (best-effort, never raises).
    Explicit ``addr``/``port`` override the env wiring; returns False
    when no rendezvous server is reachable — callers must still fail
    locally.  ``timeout`` bounds each HTTP attempt: exit paths (the
    stall shutdown) pass a short one so a dead server cannot delay the
    local exit by the full retry budget."""
    if addr is None or port is None:
        wired = _rendezvous_from_env()
        if wired is None:
            log.debug("abort flag %r: no rendezvous wiring",
                      flag.get("reason"))
            return False
        addr, port, secret = wired
    # flight-recorder: the abort flag is a chain link — the event id
    # rides the flag itself, so every rank that OBSERVES it (heartbeat)
    # can chain its own abort.observe onto this publish, across
    # processes (observe/events.py)
    try:
        from ..observe import events as events_mod

        eid = events_mod.record_event(
            "abort.publish", severity="critical",
            payload={"reason": flag.get("reason"),
                     "source": flag.get("source"),
                     "rank": flag.get("rank"),
                     "epoch": flag.get("epoch")},
            cause_id=flag.get("cause_event_id"),
            correlation_id=flag.get("correlation_id"),
            rank=flag.get("rank"))
        if eid:
            flag.setdefault("event_id", eid)
            corr = events_mod.correlation_of(eid)
            if corr:
                flag.setdefault("correlation_id", corr)
    except Exception:  # noqa: BLE001 — recording must not mask the abort
        pass
    try:
        from ..run.http_client import put_kv

        put_kv(addr, port, ABORT_SCOPE, ABORT_KEY,
               json.dumps(flag).encode(), secret=secret, retry=True,
               timeout=timeout)
    except Exception as e:  # noqa: BLE001 — a dead server must not mask
        log.warning("abort flag %r publish failed: %s",  # the abort
                    flag.get("reason"), e)
        return False
    from .. import metrics

    if metrics.on():
        metrics.ABORTS.labels(flag.get("source", "unknown")).inc()
    log.error("coordinated abort set: %s", format_abort(flag))
    return True


def trigger(reason: str, *, rank: Optional[int] = None, source: str = "api",
            addr: Optional[str] = None, port: Optional[int] = None,
            secret: Optional[bytes] = None, timeout: float = 10.0) -> bool:
    """Build + publish the job-wide abort flag (best-effort, never
    raises)."""
    return publish(make_flag(reason, rank=rank, source=source),
                   addr=addr, port=port, secret=secret, timeout=timeout)


def read_flag(addr: str, port: int,
              secret: Optional[bytes] = None) -> Optional[dict]:
    """The current abort flag on the rendezvous server (None if unset)."""
    from ..run.http_client import get_kv

    raw = get_kv(addr, port, ABORT_SCOPE, ABORT_KEY, secret=secret)
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return {"reason": "<undecodable abort flag>", "source": "unknown"}


def abort(reason: str) -> None:
    """Abort the whole job from this rank: publish the flag so every peer's
    heartbeat sees it, then raise :class:`HorovodAbortError` locally —
    one flag object, so the local error and what peers observe agree."""
    flag = make_flag(reason, source="api")
    publish(flag)
    raise HorovodAbortError(format_abort(flag))
