"""Rank-consistent auto-arming of trace+profile windows: the port of
``horovod_tpu/observe/autoarm.py``.

A confirmed step-time or straggler alert should ship with attribution,
not a bare number — so the watchdog broadcasts an *arm record* through
the rendezvous KV store and every rank moves its trace+profile window
to the same future training step:

* the watchdog writes :func:`make_arm_record`'s
  ``{"id", "start_step", "end_step", "signal", "trace_dir", "ts"}``
  to the ``observe/arm`` key — one writer, last-writer-wins;
* :func:`poll_and_apply` (worker side) runs on the telemetry flusher
  thread (metrics/timeseries.py), never the step path.  Each arm id is
  applied at most once per process: the rank's current training step
  is read off its cadence series and passed to ``timeline.arm`` /
  ``ComputeProfiler.arm`` as the translation anchor, so the broadcast
  *global* step window lands on the same steps everywhere.

The port has the worker half and the record; the watchdog that
broadcasts it is ROADMAP item 15, so until then an arm record comes from
whoever puts one under ``observe/arm`` (an operator, a test), and only a
train step whose profiler is enabled registers it (the reference's
dormant profiler comes with the watchdog).

``start_step`` is chosen by the watchdog as ``max(last cadence step
across ranks) + HVD_WATCH_ARM_MARGIN_STEPS`` — far enough ahead that
every rank sees the record before the window opens.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

#: KV location of the arm record (run/http_server.py declares the scope)
ARM_SCOPE = "observe"
ARM_KEY = "arm"

_lock = threading.Lock()
_profilers: List[Any] = []
_applied_ids: set = set()


def register_profiler(profiler: Any) -> None:
    """Training registers its ComputeProfiler here so an arm record can
    reach it (make_train_step holds it as a closure variable)."""
    with _lock:
        if profiler not in _profilers:
            _profilers.append(profiler)


def reset() -> None:
    """Test seam: forget registered profilers and applied arm ids."""
    with _lock:
        _profilers.clear()
        _applied_ids.clear()


def make_arm_record(arm_id: str, start_step: int, end_step: int,
                    signal: str, trace_dir: Optional[str]) -> Dict[str, Any]:
    return {
        "id": str(arm_id),
        "start_step": int(start_step),
        "end_step": int(end_step),
        "signal": str(signal),
        "trace_dir": trace_dir,
        "ts": time.time(),
    }


def apply_arm(record: Dict[str, Any]) -> bool:
    """Apply one arm record to this process's timeline + profilers.

    Idempotent per arm id; returns True when this call armed anything.
    """
    arm_id = str(record.get("id", ""))
    if not arm_id:
        return False
    with _lock:
        if arm_id in _applied_ids:
            return False
        _applied_ids.add(arm_id)
        profilers = list(_profilers)
    try:
        start = int(record["start_step"])
        end = int(record["end_step"])
    except (KeyError, TypeError, ValueError):
        log.debug("malformed arm record ignored: %r", record)
        return False
    trace_dir = record.get("trace_dir") or None

    # the rank's current global training step — the translation anchor
    from ..metrics import timeseries

    series = timeseries.store.series(timeseries.STEP_SECONDS)
    current = series.last_step if series is not None else None

    armed = False
    try:
        from ..timeline.timeline import timeline

        armed = timeline.arm(start, end, current_step=current,
                             directory=trace_dir) or armed
    except Exception as e:  # noqa: BLE001 — arming must never kill the flusher
        log.debug("timeline arm failed: %s", e)
    for prof in profilers:
        try:
            prof.arm(start, end, current_step=current, trace_dir=trace_dir)
            armed = True
        except Exception as e:  # noqa: BLE001
            log.debug("profiler arm failed: %s", e)
    if armed:
        log.info("auto-armed trace+profile window [%d, %d] (%s, arm %s)",
                 start, end, record.get("signal"), arm_id)
    return armed


def poll_and_apply(addr: str, port: int,
                   secret: Optional[bytes] = None) -> bool:
    """Worker side: fetch ``observe/arm`` and apply it (once per id).

    Runs on the telemetry flusher thread each flush tick; never raises.
    """
    if not env_util.get_bool(env_util.HVD_WATCH_ARM, True):
        return False
    try:
        from ..run.http_client import get_kv

        raw = get_kv(addr, port, ARM_SCOPE, ARM_KEY, secret=secret,
                     timeout=5.0)
    except Exception as e:  # noqa: BLE001
        log.debug("arm poll failed: %s", e)
        return False
    if not raw:
        return False
    try:
        record = json.loads(raw)
    except (ValueError, TypeError):
        return False
    if not isinstance(record, dict):
        return False
    return apply_arm(record)
