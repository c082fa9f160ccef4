"""Per-rank Chrome-trace communication timeline: the port of
``horovod_tpu/timeline/timeline.py``.

A writer thread drains an event queue and streams Chrome-trace JSON —
the native writer of ``csrc/timeline.cc`` (``runtime/native.py``) where
it builds, else a Python thread writing the same format
(``HVD_TIMELINE_PYTHON=1`` asks for it); :attr:`Timeline.writer_kind`
says which one is open.  The fork's behaviours are kept:

* **per-rank output** ``<dir>/<rank>/comm.json``;
* **step windowing** via ``HVD_TRACE_START_STEP`` / ``HVD_TRACE_END_STEP``:
  events are recorded inside the window only, and the file is finalized
  and the writer stopped past the end step;
* the event vocabulary: ``NEGOTIATE_<OP>`` spans, the collectives'
  activity spans named after their tensors, ``STEP`` spans around every
  train-step call, and ``CYCLE_START`` instants when
  ``HVD_TIMELINE_MARK_CYCLES`` is set.

At shutdown the compute-anatomy profiler is flushed (``compute.json``)
and the metrics registry dumped (``metrics.json``) next to
``comm.json``.  Device-side timing is the profiler's (CUDA events and,
with ``HVD_PROFILE_XLA=1``, a torch.profiler capture); this timeline
covers the host-side spans.

Opening a trace with ``HVD_METRICS_KV_*`` set runs the clock-offset
handshake against the launcher's rendezvous server and writes
``clock_sync.json`` beside ``comm.json`` (timeline/replay/clock.py);
without them it is skipped, as in the reference.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from typing import Optional

from .. import core
from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

_SHUTDOWN = object()


class _Writer:
    """Background writer thread (analog of TimelineWriter::WriterLoop,
    reference timeline.cc)."""

    kind = "python"

    def __init__(self, path: str):
        self.path = path
        self.q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-timeline-writer")
        self._closed = threading.Event()
        self._thread.start()

    def put(self, ev: dict) -> None:
        if not self._closed.is_set():
            self.q.put(ev)

    def close(self) -> None:
        if not self._closed.is_set():
            self.q.put(_SHUTDOWN)
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            f.write("[\n")
            first = True
            while True:
                item = self.q.get()
                if item is _SHUTDOWN:
                    break
                if not first:
                    f.write(",\n")
                json.dump(item, f)
                first = False
                f.flush()
            f.write("\n]\n")
        self._closed.set()


class _NativeWriter:
    """Adapter over the C++ writer thread (csrc/timeline.cc) — the native
    path, used when the native core builds; same file format."""

    kind = "native"

    def __init__(self, path: str):
        from ..runtime import native

        self._lib = native.load()
        self._h = self._lib.hvd_timeline_open(path.encode())
        if not self._h:
            raise RuntimeError(f"native timeline open failed: {path}")

    def put(self, ev: dict) -> None:
        if self._h:
            self._lib.hvd_timeline_event(
                self._h, str(ev.get("name", "")).encode(),
                str(ev.get("cat", "")).encode(),
                str(ev.get("tid", "")).encode(),
                str(ev.get("ph", "X")).encode()[:1],
                float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0)),
                int(ev.get("pid", 0)),
            )

    def close(self) -> None:
        if self._h:
            self._lib.hvd_timeline_close(self._h)
            self._h = None


def _make_writer(path: str):
    """Prefer the native writer; fall back to the Python thread
    (HVD_TIMELINE_PYTHON=1 forces the fallback)."""
    if not env_util.get_bool("HVD_TIMELINE_PYTHON"):
        try:
            return _NativeWriter(path)
        except Exception as e:  # noqa: BLE001
            log.debug("native timeline unavailable (%s); python fallback", e)
    return _Writer(path)


class Timeline:
    """Process-wide timeline recorder; one writer per controller process,
    pid field = rank so merged traces line up per-rank."""

    def __init__(self) -> None:
        self._writer: Optional[_Writer] = None
        self._dir: Optional[str] = None
        self._lock = threading.Lock()
        self._step = 0
        self._stepper: Optional[str] = None
        self._start_step = env_util.get_int(env_util.HVD_TRACE_START_STEP, 0)
        self._end_step = env_util.get_int(env_util.HVD_TRACE_END_STEP, 1 << 62)
        self._mark_cycles = env_util.get_bool(env_util.HVD_TIMELINE_MARK_CYCLES)
        self._origin = time.perf_counter()
        self._atexit_registered = False

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, directory: Optional[str] = None) -> None:
        """Open ``<dir>/<rank>/comm.json`` (reference timeline.cc:205-228).

        With the launcher's rendezvous server named (``HVD_METRICS_KV_*``
        set) the reference also runs the clock-offset handshake and drops
        ``clock_sync.json`` next to comm.json; the port raises there, the
        handshake not being ported yet (``HVD_REPLAY_CLOCK_SYNC=0`` skips
        it)."""
        directory = directory or env_util.get_str(env_util.HVD_TIMELINE) or \
            env_util.get_str(env_util.HVD_TRACE_DIR)
        if not directory:
            return
        rank = core.process_rank() if core.is_initialized() else 0
        path = os.path.join(directory, str(rank), "comm.json")
        opened = False
        with self._lock:
            if self._writer is None:
                self._writer = _make_writer(path)
                self._dir = os.path.dirname(path)
                opened = True
                # fresh trace file = fresh step window: an init() after a
                # previous run's auto-close must not inherit its counter
                # (else the new trace instantly re-closes empty)
                self._step = 0
                self._stepper = None
                self._start_step = env_util.get_int(
                    env_util.HVD_TRACE_START_STEP, 0)
                self._end_step = env_util.get_int(
                    env_util.HVD_TRACE_END_STEP, 1 << 62)
                log.debug("timeline → %s", path)
                # finalize the JSON even when the user never calls
                # shutdown() (reference closes via the writer thread at
                # process teardown / end-step auto-close); registered once
                # so init/shutdown cycles don't accumulate handlers
                if not self._atexit_registered:
                    import atexit

                    atexit.register(self.shutdown)
                    self._atexit_registered = True
        if opened:
            # network I/O — after the lock is released, and never fatal
            self._record_clock_sync(os.path.dirname(path), rank)

    def _record_clock_sync(self, rank_dir: str, rank: int) -> None:
        """Estimate this rank's trace-clock→server-clock offset against
        the rendezvous server and persist it as ``clock_sync.json``
        (timeline/replay/clock.py; applied by merge_traces).  Written as
        a sidecar, not a trace event, so it survives the native writer's
        fixed event schema."""
        if not env_util.get_bool(env_util.HVD_REPLAY_CLOCK_SYNC, True):
            return
        addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
        port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
        if not addr or not port:
            return
        secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
        secret = bytes.fromhex(secret_hex) if secret_hex else None
        try:
            from .replay.clock import estimate_offset

            est = estimate_offset(
                addr, port, secret=secret,
                samples=env_util.get_int(
                    env_util.HVD_REPLAY_CLOCK_SAMPLES, 8),
                local_clock_us=self._ts_us,
            )
            est["rank"] = rank
            with open(os.path.join(rank_dir, "clock_sync.json"), "w") as f:
                json.dump(est, f, indent=1)
            log.debug("clock sync: offset %.1f us (rtt %.1f us)",
                      est["offset_us"], est["rtt_us"])
        except Exception as e:  # noqa: BLE001
            log.debug("clock sync skipped: %s", e)

    def shutdown(self) -> None:
        # flush any open compute-anatomy profiler BEFORE the writer
        # closes: compute.json events share this timeline's clock, and
        # a job torn down mid-window must still land its artifact next
        # to comm.json (timeline/profiler.py)
        try:
            from .profiler import finalize_active

            finalize_active()
        except Exception as e:  # noqa: BLE001
            log.debug("profiler finalize on shutdown failed: %s", e)
        with self._lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None
                # the live half's post-mortem artifact: a numeric snapshot
                # next to comm.json, so one trace dir carries both the
                # spans and the counters they aggregate into
                if self._dir is not None:
                    try:
                        from ..metrics import dump_metrics_json, registry

                        if registry.enabled:
                            dump_metrics_json(
                                os.path.join(self._dir, "metrics.json")
                            )
                    except Exception as e:  # noqa: BLE001
                        log.debug("metrics.json dump failed: %s", e)
                    self._dir = None

    @property
    def writer_kind(self) -> Optional[str]:
        """``"native"`` or ``"python"`` while a writer is open, else
        None: a fallback to the Python writer is seen, not hidden."""
        w = self._writer
        return w.kind if w is not None else None

    @property
    def active(self) -> bool:
        """Writer open (regardless of the step window) — callers that
        advance the step counter must keep doing so before the window."""
        return self._writer is not None

    @property
    def enabled(self) -> bool:
        return self._writer is not None and self._in_window()

    @property
    def steps(self) -> int:
        """The calls recorded since the writer opened (the window's
        counter)."""
        return self._step

    @property
    def window(self) -> tuple:
        """The step window ``(start, end)``, both inclusive."""
        return self._start_step, self._end_step

    @property
    def rank_dir(self) -> Optional[str]:
        """This rank's trace directory while a writer is open."""
        return self._dir

    def _in_window(self) -> bool:
        return self._start_step <= self._step <= self._end_step

    # -- step windowing (fork: BYTEPS_TRACE_*_STEP) -------------------------
    def record_step(self, owner: str = "default") -> int:
        """Advance the step counter; auto-finalize at the end step
        (reference timeline.cc:101-144).

        ``owner`` dedupes composed steppers: the first component to call
        this (e.g. a ``TimelineHook`` wrapping a ``make_train_step`` loop —
        both record steps) claims the counter; other owners' calls return
        without advancing, so the window isn't double-advanced.
        """
        if self._stepper is None:
            self._stepper = owner
        if owner != self._stepper:
            return self._step
        self._step += 1
        if self._step > self._end_step:
            self.shutdown()
        return self._step

    def arm(self, start_step: int, end_step: int, *,
            current_step: Optional[int] = None,
            directory: Optional[str] = None) -> bool:
        """Move the trace window and (re)open the writer — the
        watchdog's auto-arm seam (observe/autoarm.py).

        ``start_step``/``end_step`` are *global* training-step numbers
        when ``current_step`` (the rank's cadence step) is given; they
        are translated onto this timeline's own counter (which counts
        from writer-open), so every rank's window lands on the same
        training steps regardless of when its writer opened.  Returns
        False when no writer could be opened (no directory anywhere).
        The reference's watchdog calls it from its flusher thread; in
        the port a caller arms it directly."""
        self.initialize(directory)
        with self._lock:
            if self._writer is None:
                return False
            offset = (self._step - int(current_step)
                      if current_step is not None else 0)
            self._start_step = max(int(start_step) + offset,
                                   self._step + 1)
            self._end_step = int(end_step) + offset
        log.info("timeline armed: local steps [%d, %d]",
                 self._start_step, self._end_step)
        return True

    # -- events -------------------------------------------------------------
    def _ts_us(self) -> float:
        return (time.perf_counter() - self._origin) * 1e6

    def _emit(self, ev: dict) -> None:
        w = self._writer
        if w is not None:
            w.put(ev)

    @contextlib.contextmanager
    def span(self, tensor_name: str, activity: str, rank: Optional[int] = None):
        """A complete ('X') event named by tensor with the activity as
        category — the nested-activity form of the reference's
        ActivityStart/ActivityEnd."""
        if not self.enabled:
            yield
            return
        t0 = self._ts_us()
        try:
            yield
        finally:
            self._emit({
                "name": activity,
                "cat": tensor_name,
                "ph": "X",
                "ts": t0,
                "dur": self._ts_us() - t0,
                "pid": rank if rank is not None else (
                    core.process_rank() if core.is_initialized() else 0),
                "tid": tensor_name,
            })

    def begin(self) -> Optional[float]:
        """The start of a span that :meth:`end` closes on a later call
        (an asynchronous collective, from submit to synchronize): its
        timestamp, or None outside the window."""
        return self._ts_us() if self.enabled else None

    def end(self, tensor_name: str, activity: str, t0: Optional[float],
            rank: Optional[int] = None) -> None:
        """Close a span :meth:`begin` opened at ``t0``: the same complete
        ('X') event :meth:`span` writes."""
        if t0 is None:
            return
        self._emit({
            "name": activity,
            "cat": tensor_name,
            "ph": "X",
            "ts": t0,
            "dur": self._ts_us() - t0,
            "pid": rank if rank is not None else (
                core.process_rank() if core.is_initialized() else 0),
            "tid": tensor_name,
        })

    def negotiate_start(self, tensor_name: str, op: str) -> None:
        """NEGOTIATE_<OP> begin (reference timeline.cc NegotiateStart)."""
        if self.enabled:
            self._emit({"name": f"NEGOTIATE_{op}", "cat": tensor_name,
                        "ph": "B", "ts": self._ts_us(),
                        "pid": core.process_rank() if core.is_initialized() else 0,
                        "tid": tensor_name})

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        """Per-rank readiness X event (fork NegotiateSubEvent "Sync",
        reference timeline.cc:250-259, used controller.cc:656-661)."""
        if self.enabled:
            self._emit({"name": f"{rank}", "cat": tensor_name, "ph": "X",
                        "ts": self._ts_us(), "dur": 1,
                        "pid": core.process_rank() if core.is_initialized() else 0,
                        "tid": tensor_name})

    def negotiate_end(self, tensor_name: str, op: str) -> None:
        if self.enabled:
            self._emit({"name": f"NEGOTIATE_{op}", "cat": tensor_name,
                        "ph": "E", "ts": self._ts_us(),
                        "pid": core.process_rank() if core.is_initialized() else 0,
                        "tid": tensor_name})

    def mark_cycle_start(self) -> None:
        """CYCLE_START instant (reference timeline.cc:377-384, gated by
        HOROVOD_TIMELINE_MARK_CYCLES)."""
        if self.enabled and self._mark_cycles:
            self._emit({"name": "CYCLE_START", "ph": "i", "s": "g",
                        "ts": self._ts_us(),
                        "pid": core.process_rank() if core.is_initialized() else 0,
                        "tid": "cycle"})


#: process-wide singleton, auto-enabled when HVD_TIMELINE is set at init
timeline = Timeline()
