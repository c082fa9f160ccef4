"""Metrics pusher: ship per-rank JSON snapshots to the launcher — the
port of ``horovod_tpu/metrics/push.py``.

The launcher (``python -m horovod_tpu_torch.run`` / function-mode ``run()``) owns the rendezvous
server (run/http_server.py); each worker pushes its registry snapshot to
the ``metrics`` scope under its process id, and the server's signed
``GET /metrics`` renders every rank's snapshot as one Prometheus page.
Pull would need a per-rank listener and a port per worker; push rides the
HTTP KV store that already exists for bootstrap — the same transport
choice the reference made for rendezvous (run/http/http_server.py).

Wired up in two places:

* ``core.init()`` calls :func:`start_pusher_from_env` — active when the
  launcher set ``HVD_METRICS_KV_ADDR``/``PORT``/``HVD_METRICS_SECRET``;
  the interval comes from ``HVD_METRICS_PUSH_SECONDS`` (default 5).
* ``run/task_fn.py`` pushes a final snapshot after the worker function
  returns, so short function-mode jobs are captured even if no interval
  ever elapsed.

**Delta pushes (docs/control_plane.md).**  A full snapshot grows with
the instrument count (100+ families) while most families
are idle between pushes, so the interval pusher ships only the families
that changed since the last acknowledged push: ``{"__delta__": true,
"base_id": <server incarnation>, "metrics": {changed}, "removed":
[...]}``, merged server-side into the stored full snapshot.  The
server's reply carries its ``server_id``; a restart or warm-standby
failover changes it, the next delta is rejected with 409, and the
pusher resyncs with one full snapshot — so an aggregated scrape is
never silently stale.  ``HVD_METRICS_DELTA=0`` forces full snapshots.
When the push rides a per-host relay (run/relay.py) deltas are off:
the relay coalesces to the latest full snapshot per rank and batches
upstream, which replaces the delta saving with a bigger one.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

_pusher: Optional["MetricsPusher"] = None
_lock = threading.Lock()


def push_snapshot(addr: str, port: int, rank: int,
                  secret: Optional[bytes] = None) -> bool:
    """One snapshot PUT to the launcher KV store; returns success.
    Never raises — losing a metrics sample must not fail the job."""
    from .registry import registry

    try:
        from ..run.http_client import put_kv

        payload = json.dumps(registry.snapshot()).encode()
        put_kv(addr, port, "metrics", str(rank), payload, secret=secret)
        return True
    except Exception as e:  # noqa: BLE001
        log.debug("metrics push failed: %s", e)
        return False


class MetricsPusher(threading.Thread):
    def __init__(self, addr: str, port: int, rank: int,
                 secret: Optional[bytes], interval: float) -> None:
        super().__init__(daemon=True, name="hvd-metrics-pusher")
        self.addr = addr
        self.port = port
        self.rank = rank
        self.secret = secret
        self.interval = max(float(interval), 0.5)
        self.delta_enabled = env_util.get_bool(env_util.HVD_METRICS_DELTA,
                                               True)
        # the delta base: the canonical form of every family the server
        # acknowledged, and the server incarnation that holds it
        self._last_families: Optional[dict] = None
        self._server_id: Optional[str] = None
        self.delta_pushes = 0
        self.full_pushes = 0
        self.resyncs = 0
        self.last_push_bytes = 0
        self.bytes_sent = 0
        self._stop = threading.Event()

    def push(self) -> bool:
        """One interval push: a family delta against the last
        acknowledged snapshot when possible, a full snapshot otherwise
        (first push, deltas disabled, relay-routed, or the server
        answered 409 because its incarnation changed).  Returns
        success; never raises."""
        import urllib.error

        from ..run import relay
        from ..run.http_client import put_kv_reply
        from .registry import registry

        try:
            snap = registry.snapshot()
            families = snap.get("metrics", {})
            canon = {n: json.dumps(f, sort_keys=True)
                     for n, f in families.items()}
            ep = relay.control_endpoint()
            via_relay = ep is not None and ep[2]
            # deltas need the primary's merge acknowledgement, so they
            # only run on the direct path; behind a relay, full
            # snapshots coalesce there instead
            use_delta = (self.delta_enabled and not via_relay
                         and self._server_id is not None
                         and self._last_families is not None)
            reply = None
            body = b""
            if use_delta:
                last = self._last_families
                changed = {n: families[n] for n, c in canon.items()
                           if last.get(n) != c}
                removed = [n for n in last if n not in canon]
                body = json.dumps({
                    "__delta__": True,
                    "base_id": self._server_id,
                    "metrics": changed,
                    "removed": removed,
                    "ts": snap.get("ts"),
                }).encode()
                try:
                    reply = put_kv_reply(self.addr, self.port, "metrics",
                                         str(self.rank), body,
                                         secret=self.secret)
                    self.delta_pushes += 1
                    _record_delta("delta")
                except urllib.error.HTTPError as e:
                    if e.code != 409:
                        raise
                    # server restart / standby takeover: the base is
                    # gone — resync with one full snapshot
                    self.resyncs += 1
                    _record_delta("resync")
                    use_delta = False
            if not use_delta:
                body = json.dumps(snap).encode()
                # through the relay (coalesced + batched upstream) when
                # one answers, with the shared permanent fallback to
                # the direct path — a dead relay must degrade to
                # per-rank pushes, never to silence
                reply = relay.control_put(self.addr, self.port, "metrics",
                                          str(self.rank), body,
                                          secret=self.secret,
                                          want_reply=True)
                self.full_pushes += 1
            self.last_push_bytes = len(body)
            self.bytes_sent += len(body)
            answered_by_relay = isinstance(reply, dict) \
                and bool(reply.get("relay"))
            sid = reply.get("server_id") if isinstance(reply, dict) else None
            if answered_by_relay or sid is None:
                # no merge acknowledgement to base a delta on (relay
                # replies buffer locally; a bare 200 is a pre-control-
                # plane server): keep pushing full snapshots
                self._server_id = None
                self._last_families = None
            else:
                self._server_id = sid
                self._last_families = canon
            return True
        except Exception as e:  # noqa: BLE001 — losing a sample must
            log.debug("metrics push failed: %s", e)  # not fail the job
            return False

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            self.push()

    def stop(self, final_push: bool = True) -> None:
        self._stop.set()
        if final_push:
            push_snapshot(self.addr, self.port, self.rank, self.secret)


def _record_delta(outcome: str) -> None:
    try:
        from .. import metrics

        if metrics.on():
            metrics.METRICS_DELTA_PUSHES.labels(outcome).inc()
    except Exception:  # noqa: BLE001
        pass


_atexit_registered = False


def start_pusher(addr: str, port: int, rank: int,
                 secret: Optional[bytes] = None,
                 interval: float = 5.0) -> MetricsPusher:
    """Start (or replace) the process-wide pusher thread.  Registers an
    atexit flush: a worker that exits without hvd.shutdown() — or before
    the first interval elapses — must still land its final snapshot on
    the launcher."""
    global _pusher, _atexit_registered
    with _lock:
        if _pusher is not None:
            _pusher.stop(final_push=False)
        _pusher = MetricsPusher(addr, port, rank, secret, interval)
        _pusher.start()
        if not _atexit_registered:
            import atexit

            atexit.register(stop_pusher)
            _atexit_registered = True
        return _pusher


def start_pusher_from_env(rank: int) -> Optional[MetricsPusher]:
    """Launcher-driven activation (no-op unless the launcher / run() set the
    ``HVD_METRICS_KV_*`` vars and the registry is enabled)."""
    from .registry import registry

    addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
    port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
    if not addr or not port or not registry.enabled:
        return None
    secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
    secret = bytes.fromhex(secret_hex) if secret_hex else None
    interval = env_util.get_float(env_util.HVD_METRICS_PUSH_SECONDS, 5.0)
    return start_pusher(addr, port, rank, secret, interval)


def stop_pusher() -> None:
    """Stop the pusher, flushing one final snapshot (core.shutdown)."""
    global _pusher
    with _lock:
        if _pusher is not None:
            _pusher.stop(final_push=True)
            _pusher = None
