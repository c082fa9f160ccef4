"""Always-on telemetry time-series: bounded ring-buffer history, and
its flusher: the port of ``horovod_tpu/metrics/timeseries.py``.

The registry answers "what is the value NOW"; this module answers "what
was it over the last N steps".  Each series holds
``HVD_TIMESERIES_TIERS`` rings of ``HVD_TIMESERIES_CAP`` samples: tier 0
is raw, tier *i+1* keeps one mean-folded sample per
``HVD_TIMESERIES_FACTOR`` tier-*i* samples, so memory stays fixed at
cap × tiers while the merged history reaches far back.  Appends never
raise into callers; call sites gate on :func:`on`.

A pusher thread (started from ``core.init`` next to the metrics
pusher) ships each rank's history to the launcher's ``timeseries`` KV
scope, as the reference's does: deltas on the direct path (only the raw
samples appended since the last acknowledged push, tagged with the
server incarnation ``base_id`` and the series' ``seq``; a restart 409s
the next delta and the pusher resyncs with one full snapshot), full
snapshots through a per-host relay (run/relay.py).  Each flush also
polls the ``observe/arm`` record (observe/autoarm.py).  ``GET
/timeseries`` serves the aggregate.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

#: the signal catalogue (docs/observe.md): every series name appended by
#: the runtime.  Kept here so the watchdog, hvd_watch, and the docs
#: enumerate one list.
STEP_SECONDS = "step_seconds"              # train-step cadence (training.py)
MFU_SERIES = "mfu"                         # profiler window MFU
HOST_GAP_US_SERIES = "host_gap_us"         # profiler host-gap per step
DISPATCH_US_PER_MIB = "dispatch_us_per_mib"  # eager collective cost density
SERVE_P99_MS_SERIES = "serve_p99_ms"       # serving windowed p99
RESIDUAL_NORM_SERIES = "residual_norm"     # compression error-feedback norm

KNOWN_SERIES = (
    STEP_SECONDS, MFU_SERIES, HOST_GAP_US_SERIES, DISPATCH_US_PER_MIB,
    SERVE_P99_MS_SERIES, RESIDUAL_NORM_SERIES,
)


class Series:
    """One named signal: tiered rings of ``(step, value)`` samples.

    ``step`` is the caller's logical clock (train step when one exists,
    else the append ordinal) — detectors report windows in it, and the
    auto-arm protocol broadcasts trace windows against it."""

    def __init__(self, cap: int, tiers: int, factor: int) -> None:
        self._lock = threading.Lock()
        self.cap = max(int(cap), 4)
        self.factor = max(int(factor), 2)
        self._tiers: List[deque] = [
            deque(maxlen=self.cap) for _ in range(max(int(tiers), 1))
        ]
        # per-tier fold accumulators: samples waiting to be mean-folded
        # one tier up (each holds < factor entries)
        self._pending: List[List[Tuple[float, float]]] = [
            [] for _ in self._tiers
        ]
        self.seq = 0          # total appends ever (the delta cursor)
        self.last_step = 0

    def append(self, step: Optional[int], value: float) -> None:
        with self._lock:
            self.seq += 1
            s = int(step) if step is not None else self.seq
            self.last_step = s
            v = float(value)
            self._tiers[0].append((s, v))
            # fold up: tier i's pending batch becomes one tier i+1
            # sample (mean value, last step) every `factor` samples
            carry: Optional[Tuple[float, float]] = (s, v)
            for i in range(len(self._tiers) - 1):
                if carry is None:
                    break
                pend = self._pending[i]
                pend.append(carry)
                carry = None
                if len(pend) >= self.factor:
                    mean = sum(p[1] for p in pend) / len(pend)
                    folded = (pend[-1][0], mean)
                    self._tiers[i + 1].append(folded)
                    pend.clear()
                    carry = folded

    def raw_since(self, seq: int) -> Tuple[List[Tuple[float, float]], int]:
        """``(samples, dropped)``: tier-0 samples appended after append
        ordinal ``seq``, plus how many of them aged out of the ring
        before this read (the delta pusher reports the gap instead of
        silently papering over it)."""
        with self._lock:
            gap = self.seq - seq
            if gap <= 0:
                return [], 0
            tier0 = list(self._tiers[0])
            take = min(gap, len(tier0))
            return tier0[len(tier0) - take:], gap - take

    def merged(self) -> List[Tuple[float, float]]:
        """All tiers flattened oldest→newest: coarse history first, the
        raw tail last, deduped where a coarser tier overlaps the finer
        one's span (wire/report form)."""
        with self._lock:
            tiers = [list(t) for t in self._tiers]
        out: List[Tuple[float, float]] = []
        cutoff = tiers[0][0][0] if tiers[0] else None
        for t in reversed(tiers[1:]):
            for s, v in t:
                if cutoff is None or s < cutoff:
                    out.append((s, v))
        out.extend(tiers[0])
        return out

    def snapshot(self) -> dict:
        return {
            "samples": [[s, v] for s, v in self.merged()],
            "seq": self.seq,
            "last_step": self.last_step,
        }


class TimeseriesStore:
    """Process-wide collection of named series (mirrors the metrics
    registry's enabled/singleton shape)."""

    def __init__(self, enabled: Optional[bool] = None,
                 cap: Optional[int] = None, tiers: Optional[int] = None,
                 factor: Optional[int] = None) -> None:
        self._series: Dict[str, Series] = {}
        self._lock = threading.Lock()
        self.enabled = (
            enabled if enabled is not None
            else env_util.get_bool(env_util.HVD_TIMESERIES, True)
        )
        self.cap = cap if cap is not None else env_util.get_int(
            env_util.HVD_TIMESERIES_CAP, env_util.DEFAULT_TIMESERIES_CAP)
        self.tiers = tiers if tiers is not None else env_util.get_int(
            env_util.HVD_TIMESERIES_TIERS,
            env_util.DEFAULT_TIMESERIES_TIERS)
        self.factor = factor if factor is not None else env_util.get_int(
            env_util.HVD_TIMESERIES_FACTOR,
            env_util.DEFAULT_TIMESERIES_FACTOR)

    def series(self, name: str) -> Series:
        s = self._series.get(name)
        if s is None:
            with self._lock:
                s = self._series.setdefault(
                    name, Series(self.cap, self.tiers, self.factor))
        return s

    def record(self, name: str, value: float,
               step: Optional[int] = None) -> None:
        """One sample; never raises (the history must not take down a
        dispatch or a step)."""
        if not self.enabled:
            return
        try:
            self.series(name).append(step, value)
        except Exception as e:  # noqa: BLE001
            log.debug("timeseries append failed: %s", e)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot(self) -> dict:
        """The full wire form one rank pushes (and the resync body)."""
        return {"series": {n: self.series(n).snapshot()
                           for n in self.names()}}

    def history(self, name: str) -> List[Tuple[float, float]]:
        return self.series(name).merged() if name in self._series else []

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


#: the process-wide store every instrumented layer appends into
store = TimeseriesStore()


def on() -> bool:
    """The hot-path gate: one attribute read."""
    return store.enabled


def record(name: str, value: float, step: Optional[int] = None) -> None:
    store.record(name, value, step=step)


# ---------------------------------------------------------------------------
# flush: per-rank pusher thread (delta protocol mirroring metrics/push.py)
# ---------------------------------------------------------------------------
class TimeseriesPusher(threading.Thread):
    """Ship this rank's history to the launcher's ``timeseries`` scope.

    Each flush also polls the ``observe/arm`` broadcast and applies any
    pending auto-armed trace+profile window (observe/autoarm.py) — the
    worker-side half of the alert→diagnosis loop, deliberately on this
    thread so the step path itself never gains a KV read."""

    def __init__(self, addr: str, port: int, rank: int,
                 secret: Optional[bytes], interval: float) -> None:
        super().__init__(daemon=True, name="hvd-timeseries-pusher")
        self.addr = addr
        self.port = port
        self.rank = rank
        self.secret = secret
        self.interval = max(float(interval), 0.5)
        self._server_id: Optional[str] = None
        self._acked: Dict[str, int] = {}   # series -> acked seq
        self.delta_pushes = 0
        self.full_pushes = 0
        self.resyncs = 0
        self._stop = threading.Event()

    def _delta_body(self) -> Optional[bytes]:
        series = {}
        for name in store.names():
            samples, dropped = store.series(name).raw_since(
                self._acked.get(name, 0))
            if samples or dropped:
                entry = {"samples": [[s, v] for s, v in samples],
                         "seq": store.series(name).seq}
                if dropped:
                    entry["dropped"] = dropped
                series[name] = entry
        if not series:
            return None
        return json.dumps({
            "__tsdelta__": True,
            "base_id": self._server_id,
            "series": series,
        }).encode()

    def push(self) -> bool:
        """One flush; returns success, never raises."""
        import urllib.error

        from ..run import relay
        from ..run.http_client import put_kv_reply

        try:
            ep = relay.control_endpoint()
            via_relay = ep is not None and ep[2]
            use_delta = not via_relay and self._server_id is not None
            reply = None
            if use_delta:
                body = self._delta_body()
                if body is None:
                    return True   # nothing new; skip the round trip
                try:
                    reply = put_kv_reply(
                        self.addr, self.port, "timeseries",
                        str(self.rank), body, secret=self.secret)
                    self.delta_pushes += 1
                    _record_flush("delta")
                except urllib.error.HTTPError as e:
                    if e.code != 409:
                        raise
                    self.resyncs += 1
                    _record_flush("resync")
                    use_delta = False
            if not use_delta:
                snap = store.snapshot()
                body = json.dumps(snap).encode()
                reply = relay.control_put(
                    self.addr, self.port, "timeseries", str(self.rank),
                    body, secret=self.secret, want_reply=True)
                self.full_pushes += 1
                _record_flush("full")
            answered_by_relay = isinstance(reply, dict) \
                and bool(reply.get("relay"))
            sid = reply.get("server_id") if isinstance(reply, dict) else None
            if answered_by_relay or sid is None:
                self._server_id = None
                self._acked = {}
            else:
                self._server_id = sid
                self._acked = {n: store.series(n).seq
                               for n in store.names()}
            return True
        except Exception as e:  # noqa: BLE001 — losing history must
            log.debug("timeseries push failed: %s", e)  # not fail the job
            return False

    def _poll_arm(self) -> None:
        try:
            from ..observe import autoarm

            autoarm.poll_and_apply(self.addr, self.port,
                                   secret=self.secret)
        except Exception as e:  # noqa: BLE001
            log.debug("auto-arm poll failed: %s", e)

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            self.push()
            self._poll_arm()

    def stop(self, final_push: bool = True) -> None:
        self._stop.set()
        if final_push:
            self.push()


def _record_flush(mode: str) -> None:
    try:
        from .. import metrics

        if metrics.on():
            metrics.TIMESERIES_FLUSHES.labels(mode).inc()
    except Exception:  # noqa: BLE001
        pass


_pusher: Optional[TimeseriesPusher] = None
_plock = threading.Lock()


def start_flusher(addr: str, port: int, rank: int,
                  secret: Optional[bytes] = None,
                  interval: float = 5.0) -> TimeseriesPusher:
    global _pusher
    with _plock:
        if _pusher is not None:
            _pusher.stop(final_push=False)
        _pusher = TimeseriesPusher(addr, port, rank, secret, interval)
        _pusher.start()
        return _pusher


def start_flusher_from_env(rank: int) -> Optional[TimeseriesPusher]:
    """Launcher-driven activation (core.init), mirroring
    metrics.push.start_pusher_from_env: no-op unless the launcher set
    the ``HVD_METRICS_KV_*`` wiring and the history is enabled."""
    addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
    port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
    if not addr or not port or not store.enabled:
        return None
    secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
    secret = bytes.fromhex(secret_hex) if secret_hex else None
    interval = env_util.get_float(
        env_util.HVD_TIMESERIES_FLUSH_SECONDS,
        env_util.get_float(env_util.HVD_METRICS_PUSH_SECONDS, 5.0))
    return start_flusher(addr, port, rank, secret, interval)


def stop_flusher() -> None:
    global _pusher
    with _plock:
        if _pusher is not None:
            _pusher.stop(final_push=True)
            _pusher = None
