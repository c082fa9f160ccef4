"""Always-on telemetry time-series: bounded ring-buffer history — the
local half of ``horovod_tpu/metrics/timeseries.py``.

The registry answers "what is the value NOW"; this module answers "what
was it over the last N steps".  Each series holds
``HVD_TIMESERIES_TIERS`` rings of ``HVD_TIMESERIES_CAP`` samples: tier 0
is raw, tier *i+1* keeps one mean-folded sample per
``HVD_TIMESERIES_FACTOR`` tier-*i* samples, so memory stays fixed at
cap × tiers while the merged history reaches far back.  Appends never
raise into callers; call sites gate on :func:`on`.

The flusher that ships each rank's history to the launcher
(``TimeseriesPusher``) needs the rendezvous server, which the port does
not have yet: :func:`start_flusher_from_env` raises when the environment
asks for it.
"""

from __future__ import annotations

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


def start_flusher(addr: str, port: int, rank: int, secret=None,
                  interval: float = 5.0):
    """The reference's history flusher: refused (not ported yet)."""
    del addr, port, rank, secret, interval
    from . import refuse_rendezvous

    refuse_rendezvous("the time-series flusher (metrics/timeseries.py)")


def start_flusher_from_env(rank: int) -> None:
    """No-op without the rendezvous wiring, as the reference's; with it,
    raises (the flusher is not ported yet)."""
    del rank
    from . import refuse_rendezvous, rendezvous_requested

    if rendezvous_requested() and store.enabled:
        refuse_rendezvous("the time-series flusher (metrics/timeseries.py)")
