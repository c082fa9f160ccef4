"""Synthetic open-loop load generation (the port of
``horovod_tpu/serving/loadgen.py``, the same arrivals for the same seed): seeded Poisson arrivals and
bursty traces, plus the latency/goodput summary every serving report
shares.

**Open loop** means arrivals are scheduled by the trace alone — a slow
server does not slow the offered load down (closed-loop generators
hide overload by self-throttling; an open loop exposes it as queue
growth and p99 blowup, which is exactly the signal the autoscaler
acts on).  Traces are deterministic under a seed, so the tests can pin
behaviour and ``python -m horovod_tpu_torch.serving --bench`` is
reproducible.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .broker import percentile


def poisson_arrivals(rate_rps: float, duration_s: float, seed: int,
                     start_s: float = 0.0) -> List[float]:
    """Arrival offsets (seconds) of a homogeneous Poisson process:
    exponential inter-arrival gaps at ``rate_rps``, seeded."""
    if rate_rps <= 0 or duration_s <= 0:
        return []
    rng = np.random.RandomState(seed)
    out: List[float] = []
    t = start_s
    end = start_s + duration_s
    while True:
        t += float(rng.exponential(1.0 / rate_rps))
        if t >= end:
            return out
        out.append(t)


def bursty_arrivals(base_rps: float, burst_rps: float, *,
                    pre_s: float, burst_s: float, post_s: float,
                    seed: int) -> Tuple[List[float],
                                        List[Tuple[float, float]]]:
    """A three-phase trace — steady ``base_rps``, a burst at
    ``burst_rps``, then a quiet tail at ``base_rps`` — as one sorted
    arrival list plus the burst window(s).  Each phase is an
    independent seeded Poisson segment, so the whole trace is
    deterministic under ``seed``."""
    arrivals = poisson_arrivals(base_rps, pre_s, seed, 0.0)
    burst_window = (pre_s, pre_s + burst_s)
    arrivals += poisson_arrivals(burst_rps, burst_s, seed + 1, pre_s)
    arrivals += poisson_arrivals(base_rps, post_s, seed + 2,
                                 pre_s + burst_s)
    return sorted(arrivals), [burst_window]


def summarize(records: Sequence[dict], slo_ms: float,
              burst_windows: Optional[Sequence[Tuple[float, float]]]
              = None) -> dict:
    """The serving summary: p50/p99/mean latency over completed
    requests, plus goodput = completed-within-SLO / offered — overall
    and (``goodput_under_burst``) restricted to requests that arrived
    inside a burst window, the number that shows whether the
    autoscaler actually absorbed the burst.

    ``records``: ``{"t": arrival_s, "latency_ms": float|None,
    "ok": bool}`` per offered request (``latency_ms`` None when the
    request timed out or was rejected)."""

    def _stats(recs):
        offered = len(recs)
        lats = [r["latency_ms"] for r in recs
                if r.get("ok") and r.get("latency_ms") is not None]
        good = sum(1 for r in recs
                   if r.get("ok") and r.get("latency_ms") is not None
                   and r["latency_ms"] <= slo_ms)
        return {
            "offered": offered,
            "completed": len(lats),
            "p50_ms": round(percentile(lats, 50.0), 3)
            if lats else None,
            "p99_ms": round(percentile(lats, 99.0), 3)
            if lats else None,
            "mean_ms": round(sum(lats) / len(lats), 3) if lats else None,
            "goodput": round(good / offered, 4) if offered else None,
        }

    out = _stats(list(records))
    out["slo_ms"] = slo_ms
    if burst_windows:
        in_burst = [r for r in records
                    if any(lo <= r["t"] < hi for lo, hi in burst_windows)]
        burst = _stats(in_burst)
        out["goodput_under_burst"] = burst["goodput"]
        out["burst_offered"] = burst["offered"]
        out["burst_p99_ms"] = burst["p99_ms"]
    return out


class OpenLoopLoadGenerator:
    """Play a trace open-loop against an in-process broker: ``submit``
    admits a request without blocking and returns its broker
    :class:`~horovod_tpu_torch.serving.broker.Request`
    (``RequestBroker.submit``); ``wait(req, timeout)`` blocks until it
    completes (``RequestBroker.wait``).

    The reference hands each arrival to a thread of its own that blocks
    in ``submit_and_wait``.  Starting a thread waits its turn for the
    interpreter lock, so under load that generator sends requests late
    (on an H100 host serving ResNet-50, a 2,758 rps burst up to 2.98 s
    late), and a burst past capacity needs a thread for every request
    in flight.  Here the dispatcher admits each request itself at its
    scheduled time, and one thread waits on the admitted requests in
    admission order, so nothing in flight holds a thread and a slow
    server never delays an arrival.  Waiting in admission order loses
    no time: deadlines rise with admission, and a latency ends at the
    request's own ``complete_time``.

    Latency runs from the request's **scheduled** arrival, so any delay
    in the generator counts against the SLO too.  Each record also
    carries ``late_ms``: how long after its scheduled time the request
    was admitted (the generator's own lag, which an open loop must keep
    small).

    ``make_input(i)`` builds request ``i``'s payload (seed it for
    determinism).  ``time_scale`` compresses the trace clock (0.5 runs
    a 4 s trace in 2 s) without changing the trace itself."""

    def __init__(self, submit: Callable, arrivals: Sequence[float],
                 make_input: Callable[[int], object], *,
                 wait: Callable, slo_ms: float, timeout_s: float = 30.0,
                 time_scale: float = 1.0) -> None:
        self.submit = submit
        self.wait = wait
        self.arrivals = list(arrivals)
        self.make_input = make_input
        self.slo_ms = float(slo_ms)
        self.timeout_s = float(timeout_s)
        self.time_scale = float(time_scale)
        self.records: List[dict] = []

    def _admit(self, i: int, arrival: float, due: float) -> tuple:
        """Submit request ``i`` (the dispatcher's side): its record, its
        wait deadline and its broker request (None when refused)."""
        inputs = self.make_input(i)
        now = time.monotonic()
        rec = {"t": arrival, "latency_ms": None, "ok": False,
               "rejected": False, "late_ms": (now - due) * 1000.0}
        try:
            return rec, now + self.timeout_s, self.submit(inputs)
        except Exception as e:  # noqa: BLE001 — a refusal is a recorded
            rec["rejected"] = True  # outcome, not a crash
            rec["error"] = f"{type(e).__name__}: {e}"
            return rec, None, None

    def _settle(self, admitted: "queue.SimpleQueue", t0: float) -> None:
        """Wait on each admitted request in admission order."""
        for rec, deadline, req in iter(admitted.get, None):
            if req is not None:
                try:
                    self.wait(req, max(deadline - time.monotonic(), 0.0))
                    due = t0 + rec["t"] * self.time_scale
                    rec["latency_ms"] = (req.complete_time - due) * 1000.0
                    rec["ok"] = True
                except TimeoutError:
                    pass
                except Exception as e:  # noqa: BLE001 — server errors
                    rec["rejected"] = True  # are a recorded outcome
                    rec["error"] = f"{type(e).__name__}: {e}"
            self.records.append(rec)

    def run(self, burst_windows: Optional[Sequence[Tuple[float, float]]]
            = None) -> dict:
        """Play the whole trace, settle every request, and return the
        :func:`summarize` report (records stay on ``self.records``)."""
        admitted: queue.SimpleQueue = queue.SimpleQueue()
        t0 = time.monotonic()
        waiter = threading.Thread(target=self._settle, args=(admitted, t0),
                                  daemon=True, name="hvd-loadgen-wait")
        waiter.start()
        try:
            for i, arrival in enumerate(self.arrivals):
                due = t0 + arrival * self.time_scale
                delay = due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                admitted.put(self._admit(i, arrival, due))
        finally:
            admitted.put(None)
        waiter.join(timeout=self.timeout_s + 5.0)
        return summarize(list(self.records), self.slo_ms, burst_windows)
