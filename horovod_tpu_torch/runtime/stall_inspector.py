"""Stall inspector: detect operations stuck waiting too long — the port
of ``horovod_tpu/runtime/stall_inspector.py``.

Re-design of horovod/common/stall_inspector.cc/.h (reference): warn when a
tensor has waited > HOROVOD_STALL_CHECK_TIME_SECONDS (default 60) for all
ranks to become ready (stall_inspector.h:39 CheckForStalledTensors), and
optionally shut the job down after HOROVOD_STALL_SHUTDOWN_TIME_SECONDS
(:42, :72-80 knobs).

Here a "stall" means an eager collective (``eager._host_guard``: the
process plane and the torch frontend's handles) that never completes — a
hung link, a dead host, a deadlocked input pipeline.  The inspector is a watchdog registry: callers mark
operations begun/ended; a daemon thread warns about entries alive past the
warning threshold and invokes a shutdown callback (default: log fatal +
``os._exit``) past the shutdown threshold.  The launcher-level analog
(a worker exiting kills the job, reference gloo_run.py:253-259) then tears
down the remaining hosts.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class _Entry:
    name: str
    start: float
    warned: bool = False


class StallInspector:
    def __init__(
        self,
        *,
        warning_seconds: Optional[float] = None,
        shutdown_seconds: Optional[float] = None,
        enabled: Optional[bool] = None,
        check_interval: float = 1.0,
        on_shutdown: Optional[Callable[[str], None]] = None,
    ):
        self.enabled = (
            enabled if enabled is not None
            else not env_util.get_bool(env_util.HVD_STALL_CHECK_DISABLE)
        )
        self.warning_seconds = (
            warning_seconds if warning_seconds is not None
            else env_util.get_float(env_util.HVD_STALL_CHECK_TIME_SECONDS,
                                    env_util.DEFAULT_STALL_WARNING_SECONDS)
        )
        self.shutdown_seconds = (
            shutdown_seconds if shutdown_seconds is not None
            else env_util.get_float(env_util.HVD_STALL_SHUTDOWN_TIME_SECONDS,
                                    0.0)
        )
        self.check_interval = check_interval
        self.on_shutdown = on_shutdown or self._default_shutdown
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.warnings: list = []  # (name, waited_seconds) — for tests/metrics

    def start(self) -> None:
        """Start the inspection thread (``core.init``; the reference
        never starts it, so its warnings and shutdown only fire where a
        caller runs :meth:`check_once`).  Restartable after
        :meth:`stop`."""
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="hvd-stall-inspector"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def begin(self, name: str) -> None:
        """Mark an operation in flight (analog of a tensor entering the
        negotiation table)."""
        if not self.enabled:
            return
        with self._lock:
            self._entries[name] = _Entry(name, time.monotonic())

    def end(self, name: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._entries.pop(name, None)

    def watch(self, name: str):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self.begin(name)
            try:
                yield
            finally:
                self.end(name)

        return ctx()

    def register_metrics(self) -> None:
        """Publish this inspector's state to the metrics plane: a queue-
        depth gauge (in-flight watchdog entries), a stalled-ops gauge,
        and the cumulative warning counter.  The gauges are collector-
        driven (polled at scrape/snapshot time), so the begin/end hot
        path stays untouched.  Keyed registration means re-calling (or a
        fresh singleton across hvd.init cycles) replaces, not leaks."""
        from ..metrics import INFLIGHT_OPS, STALLED_OPS, registry

        def collect() -> None:
            now = time.monotonic()
            with self._lock:
                inflight = len(self._entries)
                stalled = sum(
                    1 for e in self._entries.values()
                    if now - e.start > self.warning_seconds
                )
            INFLIGHT_OPS.set(inflight)
            STALLED_OPS.set(stalled)

        registry.register_collector("stall_inspector", collect)

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval):
            self.check_once()

    def check_once(self) -> None:
        """One inspection pass (reference CheckForStalledTensors: builds the
        warning message listing stalled tensors and waiting ranks)."""
        now = time.monotonic()
        stalled, dead = [], []
        with self._lock:
            for e in self._entries.values():
                waited = now - e.start
                if self.shutdown_seconds > 0 and waited > self.shutdown_seconds:
                    dead.append((e.name, waited))
                elif waited > self.warning_seconds and not e.warned:
                    e.warned = True
                    stalled.append((e.name, waited))
        for name, waited in stalled:
            self.warnings.append((name, waited))
            from ..metrics import STALL_WARNINGS, registry

            if registry.enabled:
                STALL_WARNINGS.inc()
            log.warning(
                "One or more operations were submitted but have not "
                "completed for %.0f seconds: [%s]. Possible causes: a hung "
                "host, a dead DCN/ICI link, or an input pipeline deadlock.",
                waited, name,
            )
        for name, waited in dead:
            self.on_shutdown(name)

    @staticmethod
    def _default_shutdown(name: str) -> None:
        """Stall shutdown = coordinated abort, then local exit.  The old
        behavior (exit alone) stranded every OTHER rank in a silent hang
        until a collective timeout; setting the job-wide flag first means
        peers raise HorovodAbortError naming this rank's stalled op
        within a heartbeat interval (elastic/abort.py)."""
        log.critical(
            "operation [%s] exceeded the stall shutdown threshold; "
            "terminating (HVD_STALL_SHUTDOWN_TIME_SECONDS)", name,
        )
        from ..elastic.abort import trigger

        # best-effort, with a SHORT per-attempt timeout: an unreachable
        # rendezvous (the launcher VM may be the thing that died) must
        # delay this exit by seconds, not the full retry budget
        trigger(
            f"stall shutdown: operation [{name}] exceeded "
            "HVD_STALL_SHUTDOWN_TIME_SECONDS",
            source="stall_inspector", timeout=2.0,
        )
        os._exit(1)


#: process-wide inspector used by the eager plane
inspector = StallInspector()
inspector.register_metrics()
