"""Per-host relay: aggregate control-plane traffic into batched PUTs —
the port of ``horovod_tpu/run/relay.py``.  ``core.init`` stands it up on
local rank 0 under ``HVD_RELAY=1``.

Every rank used to talk to the launcher's rendezvous server directly —
heartbeat renewals, metric snapshots, sanitizer fingerprints — which
put O(ranks) (sanitizer: O(ranks x groups)) requests per interval on
one ``ThreadingHTTPServer``.  The relay tree collapses that to
O(hosts) (docs/control_plane.md): **local rank 0 on each host** runs a
:class:`RelayDaemon` (elected through the same ``HVD_LOCAL_RANK``
topology ``two_level_allreduce`` computes with), local ranks send their
batchable PUTs to it over loopback, and a flusher thread ships the
coalesced buffer upstream as one signed ``PUT /batch`` every
``HVD_RELAY_FLUSH_MS``.

Semantics that make the aggregation safe:

* Only **last-writer-wins** scopes are buffered (``health``,
  ``metrics``, ``sanitizer``): coalescing the buffer to the latest
  value per key is exactly the store's own PUT semantics.  Everything
  else (membership acks, abort flags, serving traffic) passes through
  to the primary synchronously, and GET/DELETE are forwarded verbatim.
* The upstream ``/batch`` reply carries the job-wide **abort flag**;
  the relay caches it and answers local ``/health/`` renewals with it,
  so a rank's one buffered round trip still answers "is the job
  aborting" — the verdict is at most one flush interval staler than a
  direct renewal's.
* Clients **fall back** to the primary when the relay is unreachable
  (:func:`control_endpoint` / :func:`mark_relay_failed`,
  ``hvd_relay_fallbacks_total``): a dead relay degrades to
  per-rank traffic, never to silence.

The relay finds its upstream from the ordinary rendezvous wiring
(``HVD_METRICS_KV_ADDR``/``PORT``) and publishes its own address under
the ``relay`` KV scope (key = host slug) for local peers to discover;
upstream flushes ride the failover-aware client, so a relay keeps
working across a warm-standby takeover (``HVD_RENDEZVOUS_ADDRS``).
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional, Tuple

from ..utils import env as env_util
from ..utils.logging import get_logger
from .http_server import SECRET_HEADER, QuietThreadingHTTPServer, sign

log = get_logger(__name__)

#: KV scope where each host's relay publishes its address
RELAY_SCOPE = "relay"

#: scopes whose PUTs are buffered + batched (last-writer-wins keys with
#: a single writer per key); everything else passes through.  The
#: timeseries scope qualifies because relay-routed history pushes are
#: full self-contained snapshots (metrics/timeseries.py disables the
#: append-delta protocol behind a relay for exactly this reason).  The
#: events scope qualifies because every flight-recorder event carries a
#: unique per-process key (observe/events.py), so coalescing to the
#: latest value per key can never merge two distinct events.
BATCH_SCOPES = frozenset({"health", "metrics", "sanitizer", "timeseries",
                          "events"})


def host_slug() -> str:
    """Stable per-host identity for relay election/discovery: the cross
    (host) index when the launcher exported one, else the hostname."""
    cross = env_util.get_str(env_util.HVD_CROSS_RANK)
    if cross is not None:
        return f"node{cross}"
    return socket.gethostname() or "localhost"


def _record(name: str, n: int = 1) -> None:
    try:
        from .. import metrics

        if metrics.on():
            getattr(metrics, name).inc(n)
    except Exception:  # noqa: BLE001 — metrics must not fail the relay
        pass


class _RelayHandler(BaseHTTPRequestHandler):
    """The relay's local HTTP surface: the same KV wire protocol as the
    rendezvous server, so ``put_kv``/``get_kv`` work unchanged against
    it — buffered for batch scopes, proxied for everything else."""

    protocol_version = "HTTP/1.1"
    timeout = 65
    disable_nagle_algorithm = True  # same reasoning as KVStoreHandler

    def _daemon(self) -> "RelayDaemon":
        d = self.server.relay_daemon  # type: ignore[attr-defined]
        if d._stop_event.is_set():
            # stop() ran but this keep-alive connection's handler thread
            # is still alive: a PUT buffered now would never be flushed
            # (the final drain already ran), so the stopped relay must
            # look DEAD to pooled clients — connection aborted routes
            # them through mark_relay_failed to the primary
            raise ConnectionAbortedError("relay daemon stopped")
        return d

    def _verify(self, body: bytes = b"") -> bool:
        secret = self._daemon().secret
        if secret is None:
            return True
        got = self.headers.get(SECRET_HEADER, "")
        import hmac as _hmac

        return _hmac.compare_digest(got, sign(secret, self.path, body))

    def _reply(self, code: int, body: bytes = b"",
               content_type: Optional[str] = None) -> None:
        self.send_response(code)
        if content_type:
            self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _forward(self, method: str, body: bytes = b"") -> None:
        """Pass one request through to the primary, mirroring its
        status and body (the non-batchable traffic path)."""
        d = self._daemon()
        from . import http_client

        try:
            with http_client._request(method, d.upstream_addr,
                                      d.upstream_port, self.path, body,
                                      d.secret) as resp:
                self._reply(resp.status, resp.read())
        except urllib.error.HTTPError as e:
            self._reply(e.code, e.read())
        except urllib.error.URLError:
            self._reply(502, json.dumps(
                {"error": "relay: upstream unreachable"}).encode(),
                content_type="application/json")

    def do_PUT(self) -> None:  # noqa: N802
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._verify(body):
            self._reply(401)
            return
        d = self._daemon()
        scope = self.path.lstrip("/").split("/", 1)[0]
        if scope in d.batch_scopes:
            d.buffer(self.path, body)
            reply: Dict[str, object] = {"relay": True}
            if scope == "health":
                # the batched round trip's abort piggyback, served from
                # the cache the last upstream flush refreshed
                reply["abort"] = d.abort_cache
                reply["server_id"] = d.upstream_id
            self._reply(200, json.dumps(reply).encode(),
                        content_type="application/json")
            return
        self._forward("PUT", body)

    def do_GET(self) -> None:  # noqa: N802
        if not self._verify():
            self._reply(401)
            return
        self._forward("GET")

    def do_DELETE(self) -> None:  # noqa: N802
        if not self._verify():
            self._reply(401)
            return
        self._forward("DELETE")

    def do_POST(self) -> None:  # noqa: N802
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._verify(body):
            self._reply(401)
            return
        self._forward("POST", body)

    def log_message(self, fmt, *args):
        log.debug("relay: " + fmt, *args)


class RelayDaemon:
    """One host's control-plane aggregator (see module docstring)."""

    def __init__(self, upstream_addr: str, upstream_port: int,
                 secret: Optional[bytes] = None, port: Optional[int] = None,
                 flush_ms: Optional[float] = None,
                 batch_scopes: frozenset = BATCH_SCOPES):
        self.upstream_addr = upstream_addr
        self.upstream_port = int(upstream_port)
        self.secret = secret
        self.batch_scopes = frozenset(batch_scopes)
        self.flush_seconds = float(
            flush_ms if flush_ms is not None
            else env_util.get_float(env_util.HVD_RELAY_FLUSH_MS,
                                    env_util.DEFAULT_RELAY_FLUSH_MS)) / 1000.0
        listen_port = int(port if port is not None
                          else env_util.get_int(env_util.HVD_RELAY_PORT, 0))
        self._httpd = QuietThreadingHTTPServer(
            ("0.0.0.0", listen_port), _RelayHandler)
        self._httpd.relay_daemon = self  # type: ignore[attr-defined]
        self._buffer: Dict[str, bytes] = {}
        self._buffer_lock = threading.Lock()
        self.abort_cache: Optional[object] = None
        self.upstream_id: Optional[str] = None
        self.flushes = 0
        self.entries_flushed = 0
        self.flush_errors = 0
        self._stop_event = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None
        self._flush_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def buffer(self, path: str, value: bytes) -> None:
        """Coalesce one batchable PUT (latest value per key wins — the
        store's own last-writer-wins semantics)."""
        with self._buffer_lock:
            self._buffer[path] = value

    def pending(self) -> int:
        with self._buffer_lock:
            return len(self._buffer)

    def flush_now(self) -> bool:
        """Ship the buffered entries upstream as one ``PUT /batch``
        (also refreshing the abort cache); returns success.  On failure
        the entries are restored — without clobbering anything newer —
        for the next flush to carry."""
        with self._buffer_lock:
            entries = list(self._buffer.items())
            self._buffer.clear()
        from .http_client import put_batch

        try:
            reply = put_batch(self.upstream_addr, self.upstream_port,
                              entries, secret=self.secret, retry=True)
        except Exception as e:  # noqa: BLE001 — the flusher must survive
            self.flush_errors += 1
            log.debug("relay flush failed (%d entries kept): %s",
                      len(entries), e)
            with self._buffer_lock:
                for path, value in entries:
                    self._buffer.setdefault(path, value)
            return False
        self.abort_cache = reply.get("abort")
        self.upstream_id = reply.get("server_id")
        self.flushes += 1
        self.entries_flushed += len(entries)
        _record("RELAY_FLUSHES")
        if entries:
            _record("RELAY_ENTRIES", len(entries))
        return True

    def _flush_loop(self) -> None:
        # idle ticks skip the upstream request unless the abort cache
        # has gone stale (one heartbeat interval): a quiet host costs
        # O(1/interval) upstream requests, a busy one O(1/flush)
        stale_after = max(self.flush_seconds * 2.0, env_util.get_float(
            env_util.HVD_HEARTBEAT_INTERVAL_SECONDS,
            env_util.DEFAULT_HEARTBEAT_INTERVAL_SECONDS))
        last_contact = 0.0
        while not self._stop_event.wait(self.flush_seconds):
            now = time.monotonic()
            if self.pending() or now - last_contact > stale_after:
                if self.flush_now():
                    last_contact = now
        self.flush_now()  # final drain

    def start(self) -> int:
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="hvd-relay")
        self._serve_thread.start()
        self._flush_thread = threading.Thread(
            target=self._flush_loop, daemon=True, name="hvd-relay-flush")
        self._flush_thread.start()
        log.info("relay daemon for host %s on port %d (upstream %s:%d, "
                 "flush %.0f ms)", host_slug(), self.port,
                 self.upstream_addr, self.upstream_port,
                 self.flush_seconds * 1e3)
        return self.port

    def publish(self, addr: Optional[str] = None) -> None:
        """Announce this relay under ``/relay/<host>`` so local peers
        discover it (retry=True: single writer, last-writer-wins)."""
        from .http_client import put_kv

        record = json.dumps({
            "addr": addr or "127.0.0.1",
            "port": self.port,
            "host": host_slug(),
        }).encode()
        put_kv(self.upstream_addr, self.upstream_port, RELAY_SCOPE,
               host_slug(), record, secret=self.secret, retry=True)

    def stop(self) -> None:
        self._stop_event.set()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=5)
        self._httpd.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)
        # release the port: pooled keep-alive clients must see a dead
        # relay as connection-refused (→ their permanent direct
        # fallback), not a silent accept-less bind
        self._httpd.server_close()


# ---------------------------------------------------------------------------
# process-wide wiring: election (local rank 0) + client-side routing
# ---------------------------------------------------------------------------
_daemon: Optional[RelayDaemon] = None
_endpoint: Optional[Tuple[str, int, bool]] = None
_resolve_lock = threading.Lock()


def enabled() -> bool:
    return env_util.get_bool(env_util.HVD_RELAY)


def start_from_env() -> Optional[RelayDaemon]:
    """Elect + start this host's relay: runs on local rank 0 when
    ``HVD_RELAY=1`` and the launcher rendezvous is wired; no-op (and
    None) everywhere else.  Called by ``core.init()``."""
    global _daemon
    if not enabled() or _daemon is not None:
        return _daemon
    local_rank = env_util.get_int(env_util.HVD_LOCAL_RANK,
                                  env_util.get_int(env_util.HVD_PROCESS_ID,
                                                   0))
    if local_rank != 0:
        return None
    addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
    port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
    if not addr or not port:
        return None
    secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
    secret = bytes.fromhex(secret_hex) if secret_hex else None
    daemon = RelayDaemon(addr, port, secret=secret)
    daemon.start()
    try:
        daemon.publish()
    except Exception as e:  # noqa: BLE001 — peers fall back to direct
        log.warning("relay address publish failed: %s", e)
    _daemon = daemon
    return daemon


def instance() -> Optional[RelayDaemon]:
    return _daemon


def stop() -> None:
    """Stop this process's relay daemon and drop the cached endpoint
    (core.shutdown / tests)."""
    global _daemon, _endpoint
    with _resolve_lock:
        if _daemon is not None:
            _daemon.stop()
            _daemon = None
        _endpoint = None


def control_endpoint() -> Optional[Tuple[str, int, bool]]:
    """(addr, port, via_relay) that batchable control-plane writes
    should target: this host's relay when one is discoverable, else the
    primary rendezvous directly; None when no rendezvous is wired at
    all.  Resolved once and cached; :func:`mark_relay_failed` drops a
    dead relay back to the direct path."""
    global _endpoint
    if _endpoint is not None:
        return _endpoint
    addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
    port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
    if not addr or not port:
        return None
    with _resolve_lock:
        if _endpoint is not None:
            return _endpoint
        resolved: Tuple[str, int, bool] = (addr, port, False)
        if enabled():
            if _daemon is not None:
                resolved = ("127.0.0.1", _daemon.port, True)
            else:
                secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
                secret = bytes.fromhex(secret_hex) if secret_hex else None
                from .http_client import get_kv

                try:
                    raw = get_kv(addr, port, RELAY_SCOPE, host_slug(),
                                 secret=secret, wait=True, timeout=5.0)
                except Exception as e:  # noqa: BLE001
                    log.debug("relay discovery failed: %s", e)
                    raw = None
                if raw is not None:
                    try:
                        rec = json.loads(raw)
                        resolved = (str(rec["addr"]), int(rec["port"]), True)
                    except (ValueError, TypeError, KeyError):
                        log.warning("undecodable relay record for host %s; "
                                    "using the primary directly", host_slug())
        _endpoint = resolved
        return resolved


def control_put(direct_addr: str, direct_port: int, scope: str, key: str,
                value: bytes, secret: Optional[bytes] = None,
                want_reply: bool = False):
    """PUT one batchable control-plane key through this host's relay
    when one is resolved, falling back — permanently, via
    :func:`mark_relay_failed` — to the direct path when the relay is
    unreachable.  The ONE copy of the routing that the heartbeat, the
    metrics pusher, and the sanitizer share, so none of them can drift
    into silently losing its traffic behind a dead relay.  Returns the
    parsed JSON reply when ``want_reply`` (relay replies carry
    ``{"relay": true}`` so callers can tell which path answered)."""
    from .http_client import put_kv, put_kv_reply

    def send(addr, port):
        if want_reply:
            return put_kv_reply(addr, port, scope, key, value,
                                secret=secret)
        return put_kv(addr, port, scope, key, value, secret=secret)

    ep = control_endpoint()
    if ep is not None and ep[2]:
        try:
            return send(ep[0], ep[1])
        except (urllib.error.URLError, OSError):
            mark_relay_failed()
    return send(direct_addr, direct_port)


def mark_relay_failed() -> None:
    """A client's request to the relay failed at the transport level:
    fall back to the primary for the rest of this incarnation (the
    pass-through guarantee — a dead relay must not silence a host)."""
    global _endpoint
    with _resolve_lock:
        if _endpoint is not None and _endpoint[2]:
            log.warning("relay at %s:%d unreachable; falling back to the "
                        "primary rendezvous", _endpoint[0], _endpoint[1])
            _record("RELAY_FALLBACKS")
            addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
            port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
            _endpoint = (addr, port, False) if addr and port else None


def _reset_for_tests() -> None:
    global _daemon, _endpoint
    with _resolve_lock:
        _daemon = None
        _endpoint = None
