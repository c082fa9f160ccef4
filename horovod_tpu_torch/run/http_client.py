"""Client for the rendezvous KV store: the port of
``horovod_tpu/run/http_client.py``, byte for byte on the wire (reference
horovod/run/http/http_client.py: read_data_from_kvstore /
put_data_into_kvstore).

Transient-failure policy: every request to the rendezvous server crosses
a real network on a pod, so idempotent requests (GET/DELETE — the server
is a plain KV store) are retried with exponential backoff + jitter on
``URLError`` and 5xx responses.  PUTs are retried only when the caller
opts in (``retry=True``) — the store's PUTs are last-writer-wins
overwrites, so opting in is safe for keys with a single writer (the
abort flag, heartbeat leases).  Knobs: ``HVD_HTTP_RETRIES`` (default 2
retries after the first attempt) and ``HVD_HTTP_BACKOFF_MS`` (default
50 ms base, doubled per attempt).  Retries surface as the
``hvd_http_retries_total`` counter.  The ``HVD_FAULT_SPEC`` harness's
``http_drop`` faults inject here, through :data:`fault_hook`, so the
retry path itself is testable (the harness is ROADMAP item 13).

Control-plane tier additions (docs/control_plane.md):

* **Keep-alive pooling** — requests ride one persistent
  ``http.client.HTTPConnection`` per (thread, host:port) instead of a
  fresh TCP connect per call; a connection the server closed while idle
  is replaced with one silent fresh-connection retry (the send never
  reached the application layer, so even POSTs are safe).  Reuses
  surface as ``hvd_http_reuse_total``; ``HVD_HTTP_KEEPALIVE=0`` turns
  pooling off.
* **Ordered failover** — when ``HVD_RENDEZVOUS_ADDRS`` lists the target
  among several ``host:port`` entries, a request whose transport
  retries are exhausted moves on to the next address (the warm standby,
  run/journal.py), and the first live address is remembered so later
  requests skip the dead primary.  Failovers surface as
  ``hvd_cp_failovers_total``.
* **Batch surface** — :func:`put_batch` (the relay tree's upstream
  ``PUT /batch`` leg), :func:`get_scope` (cursor-based scope reads),
  and :func:`put_kv_reply` (a PUT that returns the server's JSON reply,
  e.g. the heartbeat's piggybacked abort verdict).

The reference's clients of the planes the port has not reached (the
peer-state shards, serving, the replay and projection summaries, the
sanitizer and alert tables) come with those planes (ROADMAP items
13-15); the server already answers their routes.
"""

from __future__ import annotations

import http.client
import io
import json as _json
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from base64 import b64decode, b64encode
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import env as env_util
from ..utils.logging import get_logger
from .http_server import SECRET_HEADER, sign

log = get_logger(__name__)

#: methods safe to retry without opt-in: the server's GET/DELETE are
#: idempotent (reads and prefix-deletes of a plain KV store)
_IDEMPOTENT_METHODS = ("GET", "DELETE")

#: transport errors that mean a pooled connection went stale while idle
#: (the server closed it between requests).  The request never reached
#: the application layer, so one silent fresh-connection retry — outside
#: the caller's retry budget — is safe for every method.  A *timeout* is
#: deliberately absent: the server may have processed a timed-out
#: request, so it surfaces as a normal URLError.
_STALE_ERRORS = (ConnectionResetError, BrokenPipeError,
                 http.client.RemoteDisconnected,
                 http.client.CannotSendRequest)

_pool_local = threading.local()

#: the fault-injection seam the reference's ``HVD_FAULT_SPEC`` harness
#: (``elastic/faults.py``, ROADMAP item 13) fills with its ``on_http``:
#: called with each request's path before it is sent, inside the retry
#: loop, so a drop it raises exercises the retries.  None sends every
#: request untouched.
fault_hook: Optional[Callable[[str], None]] = None


def _record_retry() -> None:
    """Count one retried request; never raises (the metrics plane must
    not take down a rendezvous request)."""
    try:
        from .. import metrics

        if metrics.on():
            metrics.HTTP_RETRIES.inc()
    except Exception:  # noqa: BLE001
        pass


def _record_counter(name: str) -> None:
    try:
        from .. import metrics

        if metrics.on():
            getattr(metrics, name).inc()
    except Exception:  # noqa: BLE001
        pass


class _Response:
    """Minimal reply object (context manager + ``read``), covering what
    callers used from urllib's response: the whole body is already read
    so the underlying connection can go back to the pool."""

    def __init__(self, status: int, data: bytes, headers):
        self.status = status
        self.code = status
        self.headers = headers
        self._data = data

    def read(self) -> bytes:
        return self._data

    def __enter__(self) -> "_Response":
        return self

    def __exit__(self, *exc) -> bool:
        return False


def _pool() -> Dict[Tuple[str, int], http.client.HTTPConnection]:
    conns = getattr(_pool_local, "conns", None)
    if conns is None:
        conns = _pool_local.conns = {}
    return conns


def reset_pool() -> None:
    """Drop this thread's pooled connections (tests / post-fork)."""
    conns = getattr(_pool_local, "conns", None)
    if conns:
        for c in conns.values():
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        conns.clear()


def _send_once(method: str, addr: str, port: int, path: str,
               body: bytes, secret: Optional[bytes],
               timeout: float) -> _Response:
    """One request over a pooled (or fresh) connection.  Raises
    ``urllib.error.HTTPError`` on non-2xx and ``urllib.error.URLError``
    on transport failure — the same surface urlopen gave callers."""
    keepalive = env_util.get_bool(env_util.HVD_HTTP_KEEPALIVE, True)
    pool = _pool() if keepalive else None
    key = (addr, int(port))
    url = f"http://{addr}:{port}{path}"
    payload = body if method in ("PUT", "POST") else None
    headers = {}
    if secret is not None:
        headers[SECRET_HEADER] = sign(secret, path, body)
    if not keepalive:
        headers["Connection"] = "close"
    for fresh_retry in (False, True):
        conn = pool.pop(key, None) if pool is not None else None
        reused = conn is not None
        if conn is None:
            conn = http.client.HTTPConnection(addr, int(port),
                                              timeout=timeout)
        elif conn.sock is not None:
            conn.sock.settimeout(timeout)
        try:
            if conn.sock is None:
                conn.connect()
                # Nagle + delayed-ACK on a persistent connection turns
                # every small request/reply exchange into ~40 ms; the
                # control plane lives on small exchanges
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except _STALE_ERRORS as e:
            conn.close()
            if reused and not fresh_retry:
                continue  # the keep-alive race: one silent fresh retry
            raise urllib.error.URLError(e)
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            raise urllib.error.URLError(e)
        if pool is not None and not resp.will_close:
            pool[key] = conn
        else:
            conn.close()
        if reused:
            _record_counter("HTTP_REUSE")
        if 200 <= resp.status < 300:
            return _Response(resp.status, data, resp.headers)
        raise urllib.error.HTTPError(url, resp.status, resp.reason,
                                     resp.headers, io.BytesIO(data))
    raise urllib.error.URLError(socket.error("unreachable"))  # pragma: no cover


def failover_targets(
        addr: str, port: int) -> Optional[List[Tuple[str, int]]]:
    """The ordered address list from ``HVD_RENDEZVOUS_ADDRS`` when the
    requested endpoint belongs to it (None otherwise — requests to
    endpoints outside the list, e.g. a per-host relay, never fail
    over)."""
    raw = env_util.get_str(env_util.HVD_RENDEZVOUS_ADDRS)
    if not raw:
        return None
    targets: List[Tuple[str, int]] = []
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok or ":" not in tok:
            continue
        host, _, p = tok.rpartition(":")
        try:
            targets.append((host, int(p)))
        except ValueError:
            continue
    if len(targets) < 2 or (addr, int(port)) not in targets:
        return None
    return targets


_active_lock = threading.Lock()
_active_target: Dict[Tuple, int] = {}


def _request(method: str, addr: str, port: int, path: str,
             body: bytes = b"", secret: Optional[bytes] = None,
             timeout: float = 10.0, retries: Optional[int] = None):
    """One HTTP request with bounded retries and ordered failover.
    ``retries=None`` applies the default policy: ``HVD_HTTP_RETRIES``
    for idempotent methods, 0 for PUTs (callers opt in via an explicit
    count).  When the target is part of ``HVD_RENDEZVOUS_ADDRS``, a
    target whose transport retries are exhausted is abandoned for the
    next address in the list (starting from the last known-live one);
    HTTP error replies (4xx/5xx) are real answers from a live server
    and never fail over."""
    if retries is None:
        retries = env_util.get_int(env_util.HVD_HTTP_RETRIES,
                                   env_util.DEFAULT_HTTP_RETRIES) \
            if method in _IDEMPOTENT_METHODS else 0
    backoff = env_util.get_float(env_util.HVD_HTTP_BACKOFF_MS,
                                 env_util.DEFAULT_HTTP_BACKOFF_MS) / 1000.0
    targets = failover_targets(addr, port)
    if targets is None:
        order: List[Tuple[str, int]] = [(addr, int(port))]
    else:
        key = tuple(targets)
        with _active_lock:
            start = _active_target.get(key, 0)
        order = [targets[(start + i) % len(targets)]
                 for i in range(len(targets))]
    last_err: Optional[BaseException] = None
    for ti, (t_addr, t_port) in enumerate(order):
        attempt = 0
        while True:
            try:
                if fault_hook is not None:
                    fault_hook(path)  # inside the loop: drops exercise retries
                resp = _send_once(method, t_addr, t_port, path, body,
                                  secret, timeout)
                if targets is not None:
                    with _active_lock:
                        _active_target[tuple(targets)] = targets.index(
                            (t_addr, t_port))
                return resp
            except urllib.error.HTTPError as e:
                # 4xx (404 rendezvous-miss, 401 bad secret) is a real
                # answer, not a transient — only server errors are
                # retried, and an erroring-but-live server is never
                # abandoned for a standby
                if e.code < 500 or attempt >= retries:
                    raise
            except urllib.error.URLError as e:
                last_err = e
                if attempt >= retries:
                    break  # transport dead past the budget: next target
            attempt += 1
            _record_retry()
            # full jitter on top of the doubling base: concurrent ranks
            # hammering a recovering server must not re-synchronize
            time.sleep(backoff * (2 ** (attempt - 1))
                       + random.uniform(0.0, backoff))
        if ti + 1 < len(order):
            _record_counter("CP_FAILOVERS")
            log.warning("rendezvous %s:%d unreachable; failing over to "
                        "%s:%d", t_addr, t_port, *order[ti + 1])
    assert last_err is not None
    raise last_err


def put_kv(addr: str, port: int, scope: str, key: str, value: bytes,
           secret: Optional[bytes] = None, retry: bool = False,
           timeout: float = 10.0) -> None:
    """PUT one key.  ``retry=True`` opts this (non-idempotent but
    last-writer-wins) write into the transient-failure retry policy —
    use it for single-writer keys like the abort flag."""
    retries = env_util.get_int(env_util.HVD_HTTP_RETRIES,
                               env_util.DEFAULT_HTTP_RETRIES) if retry else 0
    with _request("PUT", addr, port, f"/{scope}/{key}", value, secret,
                  timeout=timeout, retries=retries):
        pass


def get_kv(addr: str, port: int, scope: str, key: str,
           secret: Optional[bytes] = None,
           wait: bool = False, timeout: float = 60.0) -> Optional[bytes]:
    """GET, optionally polling until the key appears (rendezvous wait).
    The poll backs off from 50 ms toward a 1 s cap so a long rendezvous
    wait is tens of requests, not ``timeout / 0.1`` of them."""
    deadline = time.monotonic() + timeout
    delay = 0.05
    while True:
        try:
            with _request("GET", addr, port, f"/{scope}/{key}",
                          secret=secret) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404 and wait and time.monotonic() < deadline:
                time.sleep(delay)
                delay = min(delay * 1.5, 1.0)
                continue
            if e.code == 404:
                return None
            raise


def put_kv_reply(addr: str, port: int, scope: str, key: str, value: bytes,
                 secret: Optional[bytes] = None, retry: bool = False,
                 timeout: float = 10.0) -> Optional[dict]:
    """PUT one key and return the server's JSON reply (None when the
    reply carries no body — a pre-control-plane server).  The heartbeat
    rides this: a ``/health/<rank>`` renewal's reply carries the abort
    verdict, collapsing renew + abort-poll into one round trip."""
    retries = env_util.get_int(env_util.HVD_HTTP_RETRIES,
                               env_util.DEFAULT_HTTP_RETRIES) if retry else 0
    with _request("PUT", addr, port, f"/{scope}/{key}", value, secret,
                  timeout=timeout, retries=retries) as resp:
        data = resp.read()
    if not data:
        return None
    try:
        return _json.loads(data)
    except (ValueError, TypeError):
        return None


def put_batch(addr: str, port: int,
              entries: Sequence[Tuple[str, bytes]],
              secret: Optional[bytes] = None, retry: bool = False,
              timeout: float = 30.0) -> dict:
    """One ``PUT /batch`` carrying many KV entries — the relay tree's
    upstream leg (run/relay.py).  ``entries`` is ``[(path, value),
    ...]`` with full ``/scope/key`` paths.  Returns the server reply
    (``{"server_id", "abort", "applied", "skipped"}``).  Safe to opt
    into retries for last-writer-wins keys (leases, snapshots,
    fingerprints) — exactly what rides the relay."""
    body = _json.dumps({"entries": [
        {"p": p, "v": b64encode(v).decode()} for p, v in entries]}).encode()
    retries = env_util.get_int(env_util.HVD_HTTP_RETRIES,
                               env_util.DEFAULT_HTTP_RETRIES) if retry else 0
    with _request("PUT", addr, port, "/batch", body, secret,
                  timeout=timeout, retries=retries) as resp:
        return _json.loads(resp.read().decode())


def get_scope(addr: str, port: int, scope: str,
              since: Optional[int] = None,
              secret: Optional[bytes] = None,
              timeout: float = 10.0) -> dict:
    """Scope-level batch read (``GET /scope/<name>?since=V``): returns
    ``{"server_id", "version", "full", "entries": {key: bytes},
    "removed": [keys]}`` — only the keys changed after ``since`` unless
    the server answers with a full resync.  One round trip replaces a
    GET per key (the sanitizer's peer polls ride this)."""
    # ``since`` is always sent (-1 = full fetch): its presence is what
    # routes the request to the batch reader on the server
    path = f"/scope/{scope}?since={-1 if since is None else int(since)}"
    with _request("GET", addr, port, path, secret=secret,
                  timeout=timeout) as resp:
        out = _json.loads(resp.read().decode())
    out["entries"] = {k: b64decode(v)
                      for k, v in (out.get("entries") or {}).items()}
    return out


def delete_scope(addr: str, port: int, scope: str,
                 secret: Optional[bytes] = None) -> None:
    with _request("DELETE", addr, port, f"/{scope}", secret=secret):
        pass


def delete_kv(addr: str, port: int, scope: str, key: str,
              secret: Optional[bytes] = None) -> None:
    """Delete one key (the server's DELETE matches exact paths as well as
    scope prefixes) — used by the sanitizer to garbage-collect old
    fingerprints."""
    with _request("DELETE", addr, port, f"/{scope}/{key}", secret=secret):
        pass


def get_health(addr: str, port: int, secret: Optional[bytes] = None,
               timeout: float = 10.0) -> dict:
    """The failure-domain liveness view from ``GET /health``: per-rank
    heartbeat lease age + live/stale/dead verdict (computed on the
    server's clock) and the job-wide abort flag (None when unset)."""
    import json

    with _request("GET", addr, port, "/health", secret=secret,
                  timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def get_membership(addr: str, port: int, secret: Optional[bytes] = None,
                   timeout: float = 10.0) -> dict:
    """The elastic-membership table from ``GET /membership``: the
    committed epoch record (``epoch``/``world``/``controller_addr``),
    pending rejoin announcements, per-epoch ready acks, and the
    flapping-host blocklist (docs/fault_tolerance.md)."""
    import json

    with _request("GET", addr, port, "/membership", secret=secret,
                  timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def get_clock(addr: str, port: int, secret: Optional[bytes] = None,
              timeout: float = 2.0) -> float:
    """The rendezvous server's monotonic clock (µs) from ``GET /clock`` —
    one leg of the replay engine's offset-estimation handshake
    (timeline/replay/clock.py estimates rtt/offset around this call)."""
    import json

    with _request("GET", addr, port, "/clock", secret=secret,
                  timeout=timeout) as resp:
        return float(json.loads(resp.read().decode())["server_us"])


def put_autotune_plan(addr: str, port: int, seq: int, record: dict,
                      secret: Optional[bytes] = None) -> None:
    """Publish one profile-guided plan record (applied / verified /
    rolled_back — optim/profile_guided.py) under the rendezvous
    ``autotune`` scope so ``GET /autotune`` renders the per-plan table.
    Single writer (the tuner), last-writer-wins → safe to retry."""
    import json

    put_kv(addr, port, "autotune", f"plan.{int(seq)}",
           json.dumps(record).encode(), secret=secret, retry=True)


def put_profile_summary(addr: str, port: int, rank, summary: dict,
                        secret: Optional[bytes] = None) -> None:
    """Publish one rank's compute-anatomy summary (timeline/profiler.py
    window anatomy) under the rendezvous ``profile`` scope so
    ``GET /profile`` renders the cross-rank aggregate.  Single writer
    per key (the rank), last-writer-wins → safe to retry."""
    import json

    put_kv(addr, port, "profile", str(rank),
           json.dumps(summary).encode(), secret=secret, retry=True)


def get_profile(addr: str, port: int, secret: Optional[bytes] = None,
                timeout: float = 10.0) -> dict:
    """The aggregated compute-anatomy report from ``GET /profile``:
    per-rank anatomies plus the cross-rank aggregate (per-segment
    slowest rank, mean MFU, worst host gap — docs/profiling.md)."""
    import json

    with _request("GET", addr, port, "/profile", secret=secret,
                  timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def get_events(addr: str, port: int, secret: Optional[bytes] = None,
               since_ts: Optional[float] = None,
               kind: Optional[str] = None,
               timeout: float = 10.0) -> dict:
    """The control-plane flight-recorder log from ``GET /events``,
    oldest first (observe/events.py event schema), with the server's
    incarnation id + scope version for cursor/restart detection.
    ``since_ts``/``kind`` filter server-side (hvd_events --follow)."""
    import json
    from urllib.parse import urlencode

    params = {}
    if since_ts is not None:
        params["since_ts"] = repr(float(since_ts))
    if kind:
        params["kind"] = kind
    path = "/events" + (f"?{urlencode(params)}" if params else "")
    with _request("GET", addr, port, path, secret=secret,
                  timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def get_autotune(addr: str, port: int, secret: Optional[bytes] = None,
                 timeout: float = 10.0) -> dict:
    """The profile-guided tuning table from ``GET /autotune``: every
    pushed plan record plus the latest predicted/realized speedup pair
    (docs/autotune.md artifact contract)."""
    import json

    with _request("GET", addr, port, "/autotune", secret=secret,
                  timeout=timeout) as resp:
        return json.loads(resp.read().decode())


class RemoteStore:
    """The RendezvousServer's in-process store surface (put / get /
    delete / scope_items / clear_scope / health_report / ...) over
    HTTP, with its own ordered failover across ``addrs``.

    This is what detaches the :class:`~horovod_tpu_torch.elastic.driver.
    ElasticDriver` from the rendezvous process: pointed at
    ``[(primary), (standby)]`` it keeps committing epochs through a
    primary death (docs/control_plane.md), with the server-side epoch
    fence surfacing as :class:`~horovod_tpu_torch.run.http_server.
    EpochFencedError` exactly like the in-process path."""

    def __init__(self, addrs: Sequence[Tuple[str, int]],
                 secret: Optional[bytes] = None):
        self.addrs: List[Tuple[str, int]] = [
            (a, int(p)) for a, p in addrs]
        if not self.addrs:
            raise ValueError("RemoteStore needs at least one address")
        self.secret = secret
        self._active = 0
        self._lock = threading.Lock()

    @property
    def active_addr(self) -> Tuple[str, int]:
        with self._lock:
            return self.addrs[self._active]

    def _call(self, fn):
        """Run ``fn(addr, port)`` against the active address, walking
        the list on transport failure (HTTP error replies are real
        answers from a live server and never fail over)."""
        with self._lock:
            start = self._active
        last_err: Optional[BaseException] = None
        for i in range(len(self.addrs)):
            idx = (start + i) % len(self.addrs)
            addr, port = self.addrs[idx]
            try:
                out = fn(addr, port)
            except urllib.error.HTTPError:
                raise
            except (urllib.error.URLError, OSError) as e:
                last_err = e
                if i + 1 < len(self.addrs):
                    _record_counter("CP_FAILOVERS")
                    log.warning("control store %s:%d unreachable; trying "
                                "%s:%d", addr, port,
                                *self.addrs[(idx + 1) % len(self.addrs)])
                continue
            with self._lock:
                self._active = idx
            return out
        assert last_err is not None
        raise last_err

    def put(self, scope: str, key: str, value: bytes) -> None:
        def go(addr, port):
            try:
                put_kv(addr, port, scope, key, value, secret=self.secret,
                       retry=True)
            except urllib.error.HTTPError as e:
                if e.code == 409:
                    from .http_server import EpochFencedError

                    raise EpochFencedError(
                        e.read().decode() or "epoch write fenced")
                raise
        self._call(go)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        return self._call(lambda a, p: get_kv(a, p, scope, key,
                                              secret=self.secret))

    def delete(self, scope: str, key: str) -> None:
        self._call(lambda a, p: delete_kv(a, p, scope, key, self.secret))

    def clear_scope(self, scope: str) -> None:
        self._call(lambda a, p: delete_scope(a, p, scope,
                                             secret=self.secret))

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        out = self._call(lambda a, p: get_scope(a, p, scope,
                                                secret=self.secret))
        return out["entries"]

    def scope_since(self, scope: str,
                    since: Optional[int] = None) -> dict:
        return self._call(lambda a, p: get_scope(a, p, scope, since=since,
                                                 secret=self.secret))

    def health_report(self) -> dict:
        return self._call(lambda a, p: get_health(a, p,
                                                  secret=self.secret))

    def membership_report(self) -> dict:
        return self._call(lambda a, p: get_membership(a, p,
                                                      secret=self.secret))


def get_metrics(addr: str, port: int, secret: Optional[bytes] = None,
                json_form: bool = False) -> str:
    """Scrape the launcher's aggregated metrics: Prometheus text from
    ``GET /metrics`` (or the merged JSON snapshots from
    ``GET /metrics.json``), signed like every other rendezvous request."""
    path = "/metrics.json" if json_form else "/metrics"
    with _request("GET", addr, port, path, secret=secret) as resp:
        return resp.read().decode()
