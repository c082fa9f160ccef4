"""The shared request queue every inference replica pulls from: the
port of ``horovod_tpu/serving/broker.py``, the same calls giving the
same counts and order (pure host code).

The serving plane's single source of truth for request state: the
front-end router submits requests here, data-
parallel replicas pull them in batches, and completion resolves the
submitter's wait.  The broker owns the **zero-drop / zero-dup**
contract the autoscaler's epoch transitions are measured against:

* a request exists in exactly one place — the pending queue or one
  replica's in-flight table — until it is completed exactly once
  (late duplicates are counted and ignored, never re-delivered);
* a **draining** replica stops receiving new work but keeps completing
  what it pulled (the scale-down handshake, elastic/driver.py
  ``remove(drain=True)``);
* a replica that dies uncleanly has its in-flight requests **requeued**
  at the front of the queue in submission order, so a crash loses no
  request either (it costs latency, not answers).

Everything is condition-variable based and in-process; remote replicas
reach the same object through the rendezvous server's ``POST
/serving/pull`` / ``/serving/result`` routes (serving/frontend.py).
Latency/queue-depth signals feed the metrics plane
(``hvd_serve_*``) and the windowed p50/p99 the autoscaler reads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)


class QueueFullError(RuntimeError):
    """Admission control: the broker's pending queue is at
    ``HVD_SERVE_QUEUE_LIMIT`` — the front-end maps this to a 503 so
    overload degrades to rejections instead of unbounded latency."""


class Request:
    """One inference request, tracked from submit to completion."""

    __slots__ = ("id", "inputs", "submit_time", "pull_time",
                 "complete_time", "output", "error", "pulled_by",
                 "completed_by", "done")

    def __init__(self, req_id: int, inputs) -> None:
        self.id = req_id
        self.inputs = inputs
        self.submit_time = time.monotonic()
        self.pull_time: Optional[float] = None
        self.complete_time: Optional[float] = None
        self.output = None
        self.error: Optional[str] = None
        self.pulled_by: Optional[str] = None
        self.completed_by: Optional[str] = None
        self.done = threading.Event()

    def latency_s(self) -> Optional[float]:
        if self.complete_time is None:
            return None
        return self.complete_time - self.submit_time


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (0 < q <= 100) on a copy — the one
    p50/p99 rule shared by the broker window, the load generator, and
    the bench leg, so every report agrees."""
    if not values:
        return None
    vs = sorted(values)
    idx = max(int(len(vs) * q / 100.0 + 0.999999) - 1, 0)
    return vs[min(idx, len(vs) - 1)]


class RequestBroker:
    """Thread-safe continuous-batching request queue.

    ``queue_limit``: admission cap (``HVD_SERVE_QUEUE_LIMIT``).
    ``window_s``: how much completion history the p50/p99 window keeps
    (the autoscaler's latency signal; default 30 s).
    """

    def __init__(self, queue_limit: Optional[int] = None,
                 window_s: float = 30.0) -> None:
        self.queue_limit = int(
            queue_limit if queue_limit is not None
            else env_util.get_int(env_util.HVD_SERVE_QUEUE_LIMIT,
                                  env_util.DEFAULT_SERVE_QUEUE_LIMIT))
        self.window_s = float(window_s)
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._inflight: Dict[str, Dict[int, Request]] = {}
        self._draining: set = set()
        self._by_id: Dict[int, Request] = {}
        self._next_id = 0
        self._window: deque = deque()  # (complete_time, latency_s)
        # counters (mirrored into hvd_serve_* where a family exists)
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.duplicates = 0
        self.requeued = 0
        self.abandoned = 0

    # -- submitter side ------------------------------------------------------
    def submit(self, inputs) -> Request:
        """Admit one request (raises :class:`QueueFullError` at the
        cap).  Returns the tracked request; pair with :meth:`wait`."""
        with self._cond:
            if len(self._pending) >= self.queue_limit:
                self.rejected += 1
                self._record_outcome("rejected")
                raise QueueFullError(
                    f"serving queue at its {self.queue_limit}-request "
                    "admission cap")
            req = Request(self._next_id, inputs)
            self._next_id += 1
            self._pending.append(req)
            self._by_id[req.id] = req
            self.submitted += 1
            self._set_depth_gauge()
            self._cond.notify_all()
        return req

    def wait(self, req: Request, timeout: Optional[float] = None):
        """Block until ``req`` completes; returns its output.  Raises
        TimeoutError past ``timeout`` (default
        ``HVD_SERVE_TIMEOUT_SECONDS``) and RuntimeError when the
        replica failed the request."""
        if timeout is None:
            timeout = env_util.get_float(
                env_util.HVD_SERVE_TIMEOUT_SECONDS,
                env_util.DEFAULT_SERVE_TIMEOUT_SECONDS)
        if not req.done.wait(timeout):
            if self._abandon(req):
                self._record_outcome("timeout")
                raise TimeoutError(
                    f"request {req.id} not completed within {timeout:g}s")
            # a replica completed it in the race window: the answer is
            # already counted 'ok' — deliver it, don't 504 it
        if req.error is not None:
            raise RuntimeError(
                f"request {req.id} failed on replica "
                f"{req.completed_by}: {req.error}")
        return req.output

    def submit_and_wait(self, inputs, timeout: Optional[float] = None):
        return self.wait(self.submit(inputs), timeout)

    def _abandon(self, req: Request) -> bool:
        """The submitter gave up (wait timeout): withdraw the request
        so replicas don't burn capacity answering it — under sustained
        overload, serving abandoned requests keeps fresh ones timing
        out long after offered load drops.  If a replica is already
        computing it, its late completion lands as a counted duplicate
        (never a second 'ok' on top of the recorded timeout).  False
        when the request completed in the race window — the caller
        should deliver that answer, not discard it."""
        with self._cond:
            if req.complete_time is not None:
                return False
            req.complete_time = time.monotonic()
            req.error = "abandoned after wait timeout"
            self.abandoned += 1
            found = False
            for table in self._inflight.values():
                if table.pop(req.id, None) is not None:
                    found = True
            if not found:
                try:
                    self._pending.remove(req)
                except ValueError:
                    pass
            self._by_id.pop(req.id, None)
            self._set_depth_gauge()
            self._cond.notify_all()
        req.done.set()
        return True

    # -- replica side --------------------------------------------------------
    def pull(self, replica_id: str, max_n: int = 1,
             wait_s: float = 0.0) -> List[Request]:
        """Hand up to ``max_n`` pending requests to ``replica_id``,
        blocking up to ``wait_s`` for the first one.  A draining
        replica always gets ``[]`` — that is the stop-pulling half of
        the drain handshake."""
        deadline = time.monotonic() + max(wait_s, 0.0)
        with self._cond:
            while True:
                if replica_id in self._draining:
                    return []
                if self._pending:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)
            now = time.monotonic()
            batch: List[Request] = []
            table = self._inflight.setdefault(replica_id, {})
            while self._pending and len(batch) < max_n:
                req = self._pending.popleft()
                req.pull_time = now
                req.pulled_by = replica_id
                table[req.id] = req
                batch.append(req)
            self._set_depth_gauge()
        self._record_queue_wait(batch, now)
        return batch

    def complete(self, req_or_id, output, replica_id: str) -> bool:
        """Resolve one request exactly once; True iff this call was
        the resolving one.  A duplicate completion (e.g. a requeued
        request answered by both the dead replica's last gasp and its
        successor) is counted and dropped — the submitter only ever
        sees the first answer."""
        return self._finish(req_or_id, replica_id, output=output)

    def fail(self, req_or_id, error: str, replica_id: str) -> bool:
        """Resolve one request with an error (the submitter's wait
        raises); True iff this call was the resolving one."""
        return self._finish(req_or_id, replica_id, error=str(error))

    def _finish(self, req_or_id, replica_id: str, output=None,
                error: Optional[str] = None) -> bool:
        """Resolve a request exactly once; True iff THIS call resolved
        it (duplicates return False whether the result was an output or
        an error)."""
        with self._cond:
            req = req_or_id if isinstance(req_or_id, Request) \
                else self._by_id.get(req_or_id)
            if req is None or req.complete_time is not None:
                self.duplicates += 1
                return False
            req.complete_time = time.monotonic()
            req.output = output
            req.error = error
            req.completed_by = replica_id
            # evict the request from wherever it lives now: usually the
            # completer's own in-flight table, but a requeue may have
            # moved it back to the queue (late completion by the
            # original puller) or into a successor's table
            if self._inflight.get(replica_id, {}).pop(req.id,
                                                      None) is None:
                for table in self._inflight.values():
                    table.pop(req.id, None)
                try:
                    self._pending.remove(req)
                except ValueError:
                    pass
            self._by_id.pop(req.id, None)
            if error is None:
                self.completed += 1
                lat = req.latency_s()
                self._window.append((req.complete_time, lat))
                self._trim_window(req.complete_time)
                self._record_latency(lat)
                self._record_outcome("ok")
            else:
                self.failed += 1
                self._record_outcome("error")
            self._set_depth_gauge()
            self._cond.notify_all()
        req.done.set()
        return True

    # -- drain / failure handling --------------------------------------------
    def drain_begin(self, replica_id: str) -> None:
        """Stop handing work to ``replica_id``; its in-flight requests
        stay with it (a drain finishes them)."""
        with self._cond:
            self._draining.add(replica_id)
            self._cond.notify_all()

    def drain_end(self, replica_id: str) -> None:
        with self._cond:
            self._draining.discard(replica_id)

    def wait_drained(self, replica_id: str, timeout: float) -> bool:
        """Block until ``replica_id`` has no in-flight requests (True)
        or ``timeout`` passes (False) — the finish-in-flight half of
        the drain handshake."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._inflight.get(replica_id):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def inflight_count(self, replica_id: Optional[str] = None) -> int:
        with self._cond:
            if replica_id is not None:
                return len(self._inflight.get(replica_id, {}))
            return sum(len(t) for t in self._inflight.values())

    def requeue(self, replica_id: str) -> int:
        """A replica died uncleanly: push its pulled-but-incomplete
        requests back to the FRONT of the queue in submission order so
        a successor answers them — a crash costs latency, never
        answers."""
        with self._cond:
            table = self._inflight.pop(replica_id, {})
            self._draining.discard(replica_id)
            stranded = sorted(table.values(), key=lambda r: r.id)
            for req in reversed(stranded):
                req.pull_time = None
                self._pending.appendleft(req)
            n = len(stranded)
            self.requeued += n
            self._set_depth_gauge()
            if n:
                self._cond.notify_all()
        if n:
            self._record_requeues(n)
            log.warning("replica %s died with %d in-flight request(s); "
                        "requeued", replica_id, n)
        return n

    # -- signals -------------------------------------------------------------
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def window_stats(self, now: Optional[float] = None) -> dict:
        """The autoscaler's view: queue depth, in-flight totals, and
        windowed p50/p99/mean latency (ms) over the last
        ``window_s`` seconds of completions."""
        now = time.monotonic() if now is None else now
        with self._cond:
            self._trim_window(now)
            lats = [lat for _, lat in self._window]
            stats = {
                "queue_depth": len(self._pending),
                "inflight": sum(len(t) for t in self._inflight.values()),
                "draining": sorted(self._draining),
                "window_completions": len(lats),
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "duplicates": self.duplicates,
                "requeued": self.requeued,
                "abandoned": self.abandoned,
            }
        for name, q in (("p50_ms", 50.0), ("p99_ms", 99.0)):
            v = percentile(lats, q)
            stats[name] = round(v * 1000.0, 3) if v is not None else None
        stats["mean_ms"] = round(sum(lats) / len(lats) * 1000.0, 3) \
            if lats else None
        return stats

    def _trim_window(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()

    # -- metrics plumbing (never raises into the data path) ------------------
    def _set_depth_gauge(self) -> None:
        try:
            from .. import metrics

            if metrics.on():
                metrics.SERVE_QUEUE_DEPTH.set(len(self._pending))
        except Exception:  # noqa: BLE001
            pass

    def _record_outcome(self, outcome: str) -> None:
        try:
            from .. import metrics

            if metrics.on():
                metrics.SERVE_REQUESTS.labels(outcome).inc()
        except Exception:  # noqa: BLE001
            pass

    def _record_latency(self, latency_s: float) -> None:
        try:
            from .. import metrics

            if metrics.on():
                metrics.SERVE_LATENCY.observe(latency_s)
        except Exception:  # noqa: BLE001
            pass

    def _record_queue_wait(self, batch: List[Request], now: float) -> None:
        try:
            from .. import metrics

            if metrics.on():
                for req in batch:
                    metrics.SERVE_QUEUE_WAIT.observe(now - req.submit_time)
        except Exception:  # noqa: BLE001
            pass

    def _record_requeues(self, n: int) -> None:
        try:
            from .. import metrics

            if metrics.on():
                metrics.SERVE_REQUEUES.inc(n)
        except Exception:  # noqa: BLE001
            pass
