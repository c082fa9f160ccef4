"""Heartbeat leases: liveness that is observable *before* a collective
times out — the port of ``horovod_tpu/elastic/heartbeat.py``.

Each rank runs one daemon thread that, every
``HVD_HEARTBEAT_INTERVAL_SECONDS`` (default 2):

* renews this rank's lease — a signed PUT of ``{rank, count, interval,
  pid}`` into the rendezvous server's ``health`` scope (the server stamps
  the receipt on *its* clock, so lease age needs no cross-host clock
  agreement; ``GET /health`` renders per-rank age and a
  live/stale/dead verdict, run/http_server.py);
* polls the job-wide abort flag (elastic/abort.py).  When set, the next
  eager dispatch (``eager._host_guard``) or train step (training.py)
  raises :class:`~horovod_tpu_torch.elastic.abort.HorovodAbortError` naming the
  failing rank and reason — surviving ranks exit in seconds with a root
  cause instead of hanging until a transport timeout.

Wiring mirrors the metrics pusher and sanitizer: the launcher exports
``HVD_METRICS_KV_ADDR``/``PORT``/``HVD_METRICS_SECRET`` and
``core.init()`` calls :func:`start_from_env`; ``HVD_HEARTBEAT_DISABLE=1``
turns the plane off.  Lease loss is tolerated (the next interval renews);
the thread never raises into the training process.  In an elastic job
(``HVD_ELASTIC=1``) the lease carries the committed membership epoch
(elastic/membership.py), so abort flags stamped with an older epoch are
ignored, and a worker outside the committed world polls without renewing.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from ..run.http_server import (  # noqa: F401 — wire constants live with
    ABORT_KEY,                   # the server; HEALTH_SCOPE re-exported
    ABORT_SCOPE,                 # for the runtime side
    HEALTH_SCOPE,
)
from ..utils import env as env_util
from ..utils.logging import get_logger
from .abort import HorovodAbortError, format_abort

log = get_logger(__name__)


class HeartbeatThread(threading.Thread):
    """One rank's lease renewer + abort poller."""

    def __init__(self, rank: int, size: int, addr: str, port: int,
                 secret: Optional[bytes] = None,
                 interval: Optional[float] = None, epoch: int = 0,
                 renew: bool = True):
        super().__init__(daemon=True, name="hvd-heartbeat")
        self.rank = int(rank)
        self.size = int(size)
        self.addr = addr
        self.port = int(port)
        self.secret = secret
        self.interval = float(
            interval if interval is not None
            else env_util.get_float(
                env_util.HVD_HEARTBEAT_INTERVAL_SECONDS,
                env_util.DEFAULT_HEARTBEAT_INTERVAL_SECONDS,
            )
        )
        # The membership epoch this lease belongs to: abort flags stamped
        # with an OLDER epoch are stale (the elastic driver aborts epoch N
        # to commit N+1; a rank already rebuilt into N+1 must not re-abort
        # on the flag's way out) — see elastic/membership.py.
        self.epoch = int(epoch)
        # renew=False: abort-flag polling only.  A worker that is NOT in
        # the committed world (evicted while booting, or a spare awaiting
        # admission) must still observe the abort seam, but its rank key
        # may now belong to a DIFFERENT worker — renewing it would keep
        # the successor's lease alive and mask that worker's death.
        self.renew = bool(renew)
        self.abort_info: Optional[dict] = None
        self.beats = 0
        # NOT named _stop: threading.Thread has an internal _stop()
        # method, and shadowing it with an Event makes is_alive()/join()
        # on a finished thread raise TypeError
        self._stop_event = threading.Event()

    def run(self) -> None:
        self.beat()  # publish the first lease before any wait
        while not self._stop_event.wait(self.interval):
            self.beat()

    def beat(self) -> None:
        """One tick: renew the lease AND learn the abort verdict in the
        same round trip — the renewal's reply carries the flag
        (run/http_server.py ``_apply_one``; through a per-host relay the
        reply serves the relay's flush-refreshed cache).  Never raises —
        a flaky rendezvous link must not take the rank down; the
        retrying HTTP client (HVD_HTTP_RETRIES) absorbs transients."""
        from ..run import relay
        from ..run.http_client import get_kv

        lease = {
            "rank": self.rank,
            "count": self.beats,
            "interval": self.interval,
            "pid": os.getpid(),
        }
        reply = None
        try:
            if self.renew:
                # through the host relay when one is resolved, with the
                # shared permanent fallback to the direct path
                reply = relay.control_put(
                    self.addr, self.port, HEALTH_SCOPE, str(self.rank),
                    json.dumps(lease).encode(), secret=self.secret,
                    want_reply=True)
            self.beats += 1
            from .. import metrics

            if metrics.on():
                metrics.HEARTBEATS.inc()
        except Exception as e:  # noqa: BLE001
            log.debug("heartbeat lease renewal failed: %s", e)
        if reply is not None and "abort" in reply:
            info = reply.get("abort")
            if isinstance(info, dict):
                self._observe_abort(info)
            return
        # abort-poll-only mode (renew=False), a failed renewal, or a
        # reply without the piggyback: fall back to the explicit GET
        try:
            raw = get_kv(self.addr, self.port, ABORT_SCOPE, ABORT_KEY,
                         secret=self.secret)
        except Exception as e:  # noqa: BLE001
            log.debug("heartbeat abort poll failed: %s", e)
            return
        if raw is not None:
            try:
                info = json.loads(raw)
            except (ValueError, TypeError):
                info = {"reason": "<undecodable abort flag>",
                        "source": "unknown"}
            if not isinstance(info, dict):
                info = {"reason": repr(info), "source": "unknown"}
            self._observe_abort(info)

    def _observe_abort(self, info: dict) -> None:
        """Record an observed abort flag (once), honoring the epoch
        filter: flags stamped with an OLDER epoch are stale."""
        if self.abort_info is not None:
            return
        flag_epoch = info.get("epoch")
        try:
            flag_epoch = int(flag_epoch) if flag_epoch is not None \
                else None
        except (TypeError, ValueError):
            flag_epoch = None  # malformed epoch: honor like epoch-less
        if flag_epoch is not None and flag_epoch < self.epoch:
            log.debug("ignoring stale abort flag for epoch %s "
                      "(this rank is in epoch %d)", flag_epoch, self.epoch)
            return
        self.abort_info = info
        log.error("heartbeat observed %s", format_abort(self.abort_info))
        from .. import metrics

        if metrics.on():
            metrics.ABORTS.labels("observed").inc()
        # flight-recorder: chain this rank's observation onto the
        # publisher's event — the flag carries the publish event's id
        # across processes (observe/events.py)
        try:
            from ..observe import events as events_mod

            events_mod.record_event(
                "abort.observe", severity="warning",
                payload={"reason": info.get("reason"),
                         "source": info.get("source"),
                         "failed_rank": info.get("rank")},
                cause_id=info.get("event_id"),
                correlation_id=info.get("correlation_id"),
                rank=self.rank)
        except Exception:  # noqa: BLE001 — recording is best-effort
            pass
        # Keep renewing the lease: an elastic survivor lives on and
        # rebuilds, and the gap until it reaches the abort seam can
        # be a whole step or checkpoint save — letting the lease die
        # here reads as a SECOND failure to the driver.  Fail-stop
        # jobs exit moments later and server-side expiry reaps them.

    def stop(self) -> None:
        self._stop_event.set()


# ---------------------------------------------------------------------------
# process-wide wiring (core.init / the train-step and dispatch seams)
# ---------------------------------------------------------------------------
_instance: Optional[HeartbeatThread] = None
_lock = threading.Lock()


def start(rank: int, size: int, addr: str, port: int,
          secret: Optional[bytes] = None,
          interval: Optional[float] = None, epoch: int = 0,
          renew: bool = True) -> HeartbeatThread:
    """Start (or replace) the process-wide heartbeat thread."""
    global _instance
    with _lock:
        if _instance is not None:
            _instance.stop()
        _instance = HeartbeatThread(rank, size, addr, port,
                                    secret=secret, interval=interval,
                                    epoch=epoch, renew=renew)
        _instance.start()
        log.info("heartbeat active: rank %d/%d via %s:%d every %.1fs "
                 "(epoch %d%s)", _instance.rank, _instance.size, addr, port,
                 _instance.interval, _instance.epoch,
                 "" if renew else ", abort-poll only")
        return _instance


def start_from_env() -> Optional[HeartbeatThread]:
    """Launcher-driven activation: no-op unless this is a multi-process
    job with rendezvous wiring (the launcher / run() export it) and
    ``HVD_HEARTBEAT_DISABLE`` is unset.  Elastic jobs (HVD_ELASTIC=1)
    keep the heartbeat even at world size 1 — it is the channel through
    which a later grow epoch interrupts the lone rank."""
    if env_util.get_bool(env_util.HVD_HEARTBEAT_DISABLE):
        return None
    size = env_util.get_int(env_util.HVD_NUM_PROCESSES, 1)
    elastic = env_util.get_bool(env_util.HVD_ELASTIC)
    if size <= 1 and not elastic:
        return None  # a single process has no peers to outlive it
    addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
    port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
    if not addr or not port:
        return None
    secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
    secret = bytes.fromhex(secret_hex) if secret_hex else None
    rank = env_util.get_int(env_util.HVD_PROCESS_ID, 0)
    epoch = 0
    renew = True
    if elastic:
        from . import membership

        epoch = membership.current_epoch()
        rec = membership.current_record()
        if rec is not None \
                and membership.worker_id() not in rec.get("world", ()):
            # not a member of the committed world (evicted while
            # booting, or a spare awaiting admission): poll the abort
            # flag so the seam can kill/redirect us, but do NOT renew a
            # rank-keyed lease that may belong to a successor worker
            renew = False
    return start(rank, size, addr, port, secret=secret, epoch=epoch,
                 renew=renew)


def instance() -> Optional[HeartbeatThread]:
    return _instance


def stop() -> None:
    """Stop and drop the process heartbeat (core.shutdown / tests)."""
    global _instance
    with _lock:
        if _instance is not None:
            _instance.stop()
            _instance = None


def maybe_raise_abort() -> None:
    """The dispatch/train-step seam: raise if the heartbeat observed the
    job-wide abort flag.  One attribute read when nothing is wrong."""
    hb = _instance
    if hb is not None and hb.abort_info is not None:
        raise HorovodAbortError(format_abort(hb.abort_info))
