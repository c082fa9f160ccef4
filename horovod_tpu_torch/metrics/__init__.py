"""Per-rank metrics plane: the port of ``horovod_tpu/metrics/``.

A process-wide registry of counters / gauges / histograms
(``registry.py``), the instrument inventory every layer reports into
(this module, with the reference's names, labels and help text, those of
modules the port has not reached yet included) and the local time-series
history (``timeseries.py``).  ``dump_metrics_json`` writes the per-rank
snapshot the timeline leaves next to ``comm.json``.

The reference records a traced collective once a *trace*: jit traces the
step once and every later step replays the compiled program.  The port's
counterpart is once a *capture*: a collective inside a train step is
recorded when the step's program is recorded — on a card the CUDA-graph
capture (a replay runs no Python), on the CPU the step's first call —
and, in a profiler window, once more when the window's segments first
run; a collective called outside any train step is recorded on every
call (:func:`traced_recording`).

The pusher (``push.py``) ships each rank's snapshot to the launcher's
rendezvous server (``run/http_server.py`` ``GET /metrics``) when the
environment names it (``HVD_METRICS_KV_ADDR`` / ``HVD_METRICS_KV_PORT``),
as the reference's does; ``timeseries.py`` ships the history the same
way.

Metric families (all prefixed ``hvd_``; the launcher injects a ``rank``
label when it aggregates):

==============================  =========  ==================================
name                            kind       meaning
==============================  =========  ==================================
hvd_eager_collective_calls_total counter   eager dispatches, by ``op``
hvd_eager_collective_bytes_total counter   per-rank payload bytes, by ``op``
hvd_eager_collective_seconds    histogram  dispatch wall time, by ``op``
hvd_negotiation_seconds         histogram  controller negotiate(), by ``op``
hvd_host_collective_calls_total counter    host-plane ops, by ``op``/``transport``
hvd_host_collective_bytes_total counter    host-plane bytes, by ``op``/``transport``
hvd_host_collective_seconds     histogram  host-plane wall time, by ``transport``
hvd_collectives_traced_total    counter    collectives emitted at trace time
hvd_collectives_traced_bytes_total counter traced payload bytes, by ``op``
hvd_step_seconds                histogram  train-step cadence (dispatch-to-
                                           dispatch interval — honest under
                                           async dispatch, see training.py)
hvd_steps_total                 counter    train steps dispatched
hvd_samples_total               counter    global samples dispatched
hvd_train_loss                  gauge      trailing async loss fetch (N
                                           steps old by construction —
                                           never a pipeline stall)
hvd_ring_ops_total              counter    ring-plane transfers, by ``op``
hvd_ring_bytes_total            counter    ring-plane payload bytes
hvd_ring_active                 gauge      1 when the peer ring is up
hvd_inflight_ops                gauge      stall-inspector watchdog entries
hvd_stalled_ops                 gauge      entries past the warning threshold
hvd_stall_warnings_total        counter    cumulative stall warnings
hvd_controller_cycles           gauge      coordinator negotiation cycles
hvd_controller_cache_hits       gauge      coordinator response-cache hits
hvd_controller_stall_warnings   gauge      coordinator-side stall warnings
hvd_join_events_total           counter    elastic host-plane join() calls
hvd_sanitizer_checks_total      counter    sanitizer fingerprints verified
hvd_sanitizer_mismatches_total  counter    sanitizer divergences raised
hvd_heartbeats_total            counter    lease renewals pushed to /health
hvd_aborts_total                counter    coordinated aborts, by ``source``
hvd_http_retries_total          counter    rendezvous HTTP requests retried
hvd_faults_injected_total       counter    HVD_FAULT_SPEC faults, by ``kind``
hvd_restarts_total              counter    supervised job relaunches (launcher)
hvd_membership_epochs_total     counter    elastic membership epochs committed
hvd_ranks_removed_total         counter    workers removed from the world
hvd_ranks_admitted_total        counter    workers admitted into the world
hvd_autotune_predicted_speedup  gauge      replay-predicted speedup of the
                                           applied fusion plan (percent)
hvd_autotune_realized_speedup   gauge      realized speedup of the applied
                                           plan vs its baseline window (pct)
hvd_autotune_plans_applied_total counter   profile-guided plans applied live
hvd_autotune_rollbacks_total    counter    plans rolled back past guard band
hvd_mfu                         gauge      measured MFU over the compute-
                                           anatomy profiler's window
hvd_step_phase_fraction         gauge      share of profiled step wall time
                                           per phase (by ``phase`` label)
hvd_host_gap_us                 gauge      per-step device-idle-on-host time
                                           from inter-dispatch gaps
hvd_serve_requests_total        counter    inference requests, by ``outcome``
hvd_serve_latency_seconds       histogram  request submit→complete latency
hvd_serve_queue_wait_seconds    histogram  request submit→pull queue wait
hvd_serve_batch_fill            histogram  real (pre-padding) batch sizes
hvd_serve_queue_depth           gauge      pending requests in the broker
hvd_serve_replicas              gauge      live inference replicas
hvd_serve_p99_ms                gauge      windowed p99 request latency
hvd_serve_autoscale_events_total counter   autoscale actions, by ``direction``
hvd_serve_drains_total          counter    lossless drain handshakes done
hvd_serve_requeues_total        counter    in-flight requests requeued after
                                           a replica died uncleanly
hvd_projection_step_us          gauge      digital-twin projected step time,
                                           by target ``world``
hvd_projection_efficiency       gauge      projected scaling efficiency vs
                                           the source replay baseline
hvd_projection_err_pct          gauge      tracked projected-vs-measured
                                           step-time error of the twin
hvd_alerts_total                counter    watchdog alerts raised, by
                                           ``signal``/``severity``
                                           (horovod_tpu/observe/)
hvd_watch_arms_total            counter    trace+profile windows auto-armed
                                           by a confirmed alert
hvd_timeseries_flushes_total    counter    time-series history flushes, by
                                           ``mode`` (delta/full/resync)
hvd_events_total                counter    flight-recorder events emitted,
                                           by ``kind``/``severity``
                                           (observe/events.py)
hvd_events_dropped_total        counter    events dropped on per-process
                                           ring overflow (oldest evicted)
hvd_snapshots_total             counter    peer-tier snapshot generations
                                           committed (elastic/peerstate.py)
hvd_snapshot_bytes_total        counter    serialized snapshot bytes pushed
                                           to peers
hvd_snapshot_failures_total     counter    async snapshot attempts that died
                                           before their commit marker
hvd_snapshot_stall_us           gauge      step-path stall of the last
                                           snapshot enqueue, microseconds
hvd_snapshot_gen                gauge      newest own generation committed
                                           to the peer tier
hvd_snapshot_reprotected_total  counter    shards re-pushed to restore
                                           K-redundancy after a shrink
hvd_restores_total              counter    state restores completed, by
                                           ``source`` (peer/storage)
==============================  =========  ==================================
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..utils import env as env_util
from .registry import (  # noqa: F401
    BYTES_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS,
    MetricsRegistry,
    exponential_buckets,
    latency_buckets_from_env,
    registry,
    render_prometheus,
)

#: serving-request latency scheme: the default floor (100 µs) is tuned
#: for dispatch spans; request latencies live in the 0.25 ms..30 s range
#: (HVD_SERVE_LATENCY_BUCKET_FLOOR moves the floor; factor/count shared
#: with the job-wide HVD_METRICS_BUCKET_{FACTOR,COUNT})
SERVE_LATENCY_BUCKETS = latency_buckets_from_env(
    env_util.HVD_SERVE_LATENCY_BUCKET_FLOOR,
    env_util.DEFAULT_SERVE_LATENCY_BUCKET_FLOOR)

# -- instrument inventory ----------------------------------------------------
EAGER_CALLS = registry.counter(
    "hvd_eager_collective_calls_total",
    "Eager collective dispatches by op type.", ("op",))
EAGER_BYTES = registry.counter(
    "hvd_eager_collective_bytes_total",
    "Per-rank payload bytes moved by eager collectives.", ("op",))
EAGER_SECONDS = registry.histogram(
    "hvd_eager_collective_seconds",
    "Eager collective dispatch wall time.", ("op",))
NEGOTIATE_SECONDS = registry.histogram(
    "hvd_negotiation_seconds",
    "Controller negotiation (submit+wait) wall time.", ("op",))

HOST_CALLS = registry.counter(
    "hvd_host_collective_calls_total",
    "Host-plane collective ops by transport (ring/star/mesh).",
    ("op", "transport"))
HOST_BYTES = registry.counter(
    "hvd_host_collective_bytes_total",
    "Host-plane collective payload bytes by transport.",
    ("op", "transport"))
HOST_SECONDS = registry.histogram(
    "hvd_host_collective_seconds",
    "Host-plane collective wall time by transport.", ("transport",))

TRACED_CALLS = registry.counter(
    "hvd_collectives_traced_total",
    "Collective HLOs emitted during SPMD tracing (per compile, not per "
    "step).", ("op",))
TRACED_BYTES = registry.counter(
    "hvd_collectives_traced_bytes_total",
    "Per-rank payload bytes of traced collectives.", ("op",))
TRACED_GROUP_CALLS = registry.counter(
    "hvd_collectives_traced_group_total",
    "Traced collectives dispatched over a restricted communication "
    "group (two-level local/cross stages, process sets) — the group-"
    "labelled inventory the schedule checker and sanitizer reason "
    "about.", ("op", "group"))

STEP_SECONDS = registry.histogram(
    "hvd_step_seconds",
    "Train-step cadence: interval between successive step dispatches "
    "(equals real step time in steady state under async dispatch).")
STEPS_TOTAL = registry.counter(
    "hvd_steps_total", "Train steps dispatched.")
SAMPLES_TOTAL = registry.counter(
    "hvd_samples_total", "Global samples dispatched into train steps.")
TRAIN_LOSS = registry.gauge(
    "hvd_train_loss",
    "Most recently fetched training loss — fetched on the trailing "
    "HVD_LOSS_FETCH_STEPS cadence (training.py), so the value is N "
    "steps old and the fetch never drains the dispatch pipeline.")

RING_OPS = registry.counter(
    "hvd_ring_ops_total", "Peer-ring transfers executed.", ("op",))
RING_BYTES = registry.counter(
    "hvd_ring_bytes_total", "Peer-ring payload bytes transferred.")
RING_ACTIVE = registry.gauge(
    "hvd_ring_active", "1 while the peer-ring data plane is established.")

INFLIGHT_OPS = registry.gauge(
    "hvd_inflight_ops", "Operations currently in the stall-inspector "
    "watchdog table (negotiation/dispatch queue depth).")
STALLED_OPS = registry.gauge(
    "hvd_stalled_ops", "Watchdog entries past the warning threshold.")
STALL_WARNINGS = registry.counter(
    "hvd_stall_warnings_total", "Cumulative stall warnings emitted.")

CONTROLLER_CYCLES = registry.gauge(
    "hvd_controller_cycles", "Coordinator negotiation cycles completed.")
CONTROLLER_CACHE_HITS = registry.gauge(
    "hvd_controller_cache_hits", "Coordinator response-cache hits.")
CONTROLLER_STALLS = registry.gauge(
    "hvd_controller_stall_warnings", "Coordinator-side stall warnings.")

JOIN_EVENTS = registry.counter(
    "hvd_join_events_total", "Elastic host-plane join() barriers entered.")

SANITIZER_CHECKS = registry.counter(
    "hvd_sanitizer_checks_total",
    "Collective-sanitizer fingerprint checks that verified clean.")
SANITIZER_MISMATCHES = registry.counter(
    "hvd_sanitizer_mismatches_total",
    "Collective-sanitizer divergences detected (signature mismatch or "
    "silent peer).")

HEARTBEATS = registry.counter(
    "hvd_heartbeats_total",
    "Heartbeat lease renewals pushed to the rendezvous /health scope.")
ABORTS = registry.counter(
    "hvd_aborts_total",
    "Coordinated aborts by source plane (launcher/stall_inspector/api) "
    "plus 'observed' on ranks whose heartbeat saw the flag.", ("source",))
HTTP_RETRIES = registry.counter(
    "hvd_http_retries_total",
    "Rendezvous HTTP requests retried after a transient failure "
    "(URLError or 5xx).")
HTTP_REUSE = registry.counter(
    "hvd_http_reuse_total",
    "Rendezvous HTTP requests served over a pooled keep-alive "
    "connection instead of a fresh TCP connect (run/http_client.py).")
CP_FAILOVERS = registry.counter(
    "hvd_cp_failovers_total",
    "Requests that abandoned a dead rendezvous address for the next "
    "entry of the HVD_RENDEZVOUS_ADDRS failover list.")
RELAY_FLUSHES = registry.counter(
    "hvd_relay_flushes_total",
    "Per-host relay upstream batch flushes (run/relay.py; one PUT "
    "/batch each, replacing one request per buffered key).")
RELAY_ENTRIES = registry.counter(
    "hvd_relay_entries_total",
    "KV entries the per-host relay aggregated into upstream batches.")
RELAY_FALLBACKS = registry.counter(
    "hvd_relay_fallbacks_total",
    "Control-plane clients that fell back from an unreachable per-host "
    "relay to the primary rendezvous (pass-through mode).")
METRICS_DELTA_PUSHES = registry.counter(
    "hvd_metrics_delta_pushes_total",
    "Metric snapshot pushes sent as family deltas instead of full "
    "snapshots (metrics/push.py), by outcome.", ("outcome",))
FAULTS_INJECTED = registry.counter(
    "hvd_faults_injected_total",
    "Faults injected by the HVD_FAULT_SPEC harness, by kind.", ("kind",))
RESTARTS = registry.counter(
    "hvd_restarts_total",
    "Supervised job relaunches performed by the tpurun restart policy "
    "(launcher-side).")
MEMBERSHIP_EPOCHS = registry.counter(
    "hvd_membership_epochs_total",
    "Elastic membership epochs committed by the driver (launcher-side; "
    "includes the initial world).")
RANKS_REMOVED = registry.counter(
    "hvd_ranks_removed_total",
    "Workers removed from the elastic world (crashes, lease expiries, "
    "partitions).")
RANKS_ADMITTED = registry.counter(
    "hvd_ranks_admitted_total",
    "Workers admitted into the elastic world at epoch boundaries "
    "(rejoins and spare hosts).")

SNAPSHOTS_TOTAL = registry.counter(
    "hvd_snapshots_total",
    "Peer-tier snapshot generations committed by this rank "
    "(elastic/peerstate.py).")
SNAPSHOT_BYTES = registry.counter(
    "hvd_snapshot_bytes_total",
    "Serialized snapshot bytes this rank pushed to its replica peers.")
SNAPSHOT_FAILURES = registry.counter(
    "hvd_snapshot_failures_total",
    "Async snapshot attempts that failed before writing their commit "
    "marker (the generation stays unrestorable; storage tier covers).")
SNAPSHOT_STALL_US = registry.gauge(
    "hvd_snapshot_stall_us",
    "Step-path stall of the last snapshot enqueue in microseconds — "
    "the ONLY checkpoint cost the training step pays on the peer tier.")
SNAPSHOT_GEN = registry.gauge(
    "hvd_snapshot_gen",
    "Newest generation (= step) this rank committed to the peer tier.")
SNAPSHOT_REPROTECTED = registry.counter(
    "hvd_snapshot_reprotected_total",
    "Shards re-pushed to new peers to restore K-redundancy after a "
    "world shrink orphaned their replicas.")
RESTORES = registry.counter(
    "hvd_restores_total",
    "State restores completed, by source tier (peer/storage).",
    ("source",))

AUTOTUNE_PREDICTED_SPEEDUP = registry.gauge(
    "hvd_autotune_predicted_speedup",
    "Replay-predicted speedup (percent) of the currently applied "
    "profile-guided fusion plan (optim/profile_guided.py).")
AUTOTUNE_REALIZED_SPEEDUP = registry.gauge(
    "hvd_autotune_realized_speedup",
    "Realized speedup (percent) of the applied plan's verify window "
    "against its baseline window.")
AUTOTUNE_PLANS_APPLIED = registry.counter(
    "hvd_autotune_plans_applied_total",
    "Profile-guided fusion plans applied live through the re-jit seam.")
AUTOTUNE_ROLLBACKS = registry.counter(
    "hvd_autotune_rollbacks_total",
    "Applied plans rolled back because realized speedup lagged the "
    "prediction past the guard band.")

MFU = registry.gauge(
    "hvd_mfu",
    "Model-FLOPs utilization measured by the compute-anatomy profiler "
    "over its capture window (timeline/profiler.py: cost_analysis flops "
    "over measured step wall time, divided by utils/flops.peak_flops — "
    "the same single-sourced peak the bench JSON divides by).")
STEP_PHASE_FRACTION = registry.gauge(
    "hvd_step_phase_fraction",
    "Fraction of the profiled step's wall time spent in each phase "
    "(forward/backward/grad_allreduce/optimizer_update/host_gap).",
    ("phase",))
HOST_GAP_US = registry.gauge(
    "hvd_host_gap_us",
    "Per-step device-idle-waiting-on-host time detected from "
    "inter-dispatch gaps inside the profiled window.")

SERVE_REQUESTS = registry.counter(
    "hvd_serve_requests_total",
    "Inference requests by outcome (ok/error/timeout/rejected) — "
    "serving plane, horovod_tpu/serving/.", ("outcome",))
SERVE_LATENCY = registry.histogram(
    "hvd_serve_latency_seconds",
    "Inference request latency, submit to complete (the number the SLO "
    "is written against).", buckets=SERVE_LATENCY_BUCKETS)
SERVE_QUEUE_WAIT = registry.histogram(
    "hvd_serve_queue_wait_seconds",
    "Time a request waited in the broker queue before a replica pulled "
    "it (queueing delay component of hvd_serve_latency_seconds).",
    buckets=SERVE_LATENCY_BUCKETS)
SERVE_BATCH_FILL = registry.histogram(
    "hvd_serve_batch_fill",
    "Real (pre-padding) batch sizes formed by the continuous batcher.",
    buckets=exponential_buckets(1.0, 2.0, 9))
SERVE_QUEUE_DEPTH = registry.gauge(
    "hvd_serve_queue_depth",
    "Requests pending in the serving broker queue (the autoscaler's "
    "primary load signal).")
SERVE_REPLICAS = registry.gauge(
    "hvd_serve_replicas",
    "Live inference replicas pulling from the broker.")
SERVE_P99_MS = registry.gauge(
    "hvd_serve_p99_ms",
    "Windowed p99 request latency in milliseconds (compared against "
    "HVD_SERVE_SLO_MS by the autoscaler).")
SERVE_AUTOSCALE_EVENTS = registry.counter(
    "hvd_serve_autoscale_events_total",
    "Membership epochs committed by the serving autoscaler, by "
    "direction (grow/shrink).", ("direction",))
SERVE_DRAINS = registry.counter(
    "hvd_serve_drains_total",
    "Lossless drain handshakes completed before a scale-down removal "
    "(elastic/driver.py).")
SERVE_REQUEUES = registry.counter(
    "hvd_serve_requeues_total",
    "In-flight requests returned to the queue after a replica died "
    "without completing them.")

PROJECTION_STEP_US = registry.gauge(
    "hvd_projection_step_us",
    "Digital-twin projected step time in µs for one target topology "
    "(timeline/replay/projection.py; labeled by target world size).",
    ("world",))
PROJECTION_EFFICIENCY = registry.gauge(
    "hvd_projection_efficiency",
    "Projected scaling efficiency (source replay baseline over projected "
    "step) for one target topology, by target world size.", ("world",))
PROJECTION_ERR_PCT = registry.gauge(
    "hvd_projection_err_pct",
    "Projected-vs-measured step-time error of the digital twin on a "
    "world that was actually run (the twin's tracked accuracy — "
    "docs/projection.md validation contract).")

ALERTS_TOTAL = registry.counter(
    "hvd_alerts_total",
    "Online-watchdog alerts raised by the observe/ detectors, by signal "
    "(step_time_regression/straggler/mfu_drop/comm_beta_drift/slo_burn) "
    "and severity (warning/critical) — docs/observe.md.",
    ("signal", "severity"))
WATCH_ARMS = registry.counter(
    "hvd_watch_arms_total",
    "Trace+profile windows auto-armed by a confirmed step-time or "
    "straggler alert (observe/watchdog.py KV broadcast).")
TIMESERIES_FLUSHES = registry.counter(
    "hvd_timeseries_flushes_total",
    "Time-series history flushes shipped to the launcher, by mode "
    "(delta/full/resync) — metrics/timeseries.py.", ("mode",))
EVENTS_TOTAL = registry.counter(
    "hvd_events_total",
    "Control-plane flight-recorder events emitted, by kind "
    "(epoch.commit/abort.publish/restart.attempt/...) and severity "
    "(observe/events.py, docs/observe.md).", ("kind", "severity"))
EVENTS_DROPPED = registry.counter(
    "hvd_events_dropped_total",
    "Flight-recorder events dropped on per-process ring overflow "
    "(oldest evicted; raise HVD_EVENTS_RING_CAP if nonzero).")

COMPRESSION_RESIDUAL_NORM = registry.gauge(
    "hvd_compression_residual_norm",
    "Global L2 norm of the error-feedback residual pytree, sampled every "
    "HVD_COMPRESSION_GUARD_STEPS steps (ops/compression.py; a healthy EF "
    "loop keeps this bounded by the per-step quantization error).")
COMPRESSION_FALLBACKS = registry.counter(
    "hvd_compression_fallbacks_total",
    "Automatic fall-backs to uncompressed allreduce after the error-"
    "feedback residual diverged (training.py convergence guard).")
TWO_LEVEL_FALLBACKS = registry.counter(
    "hvd_two_level_fallbacks_total",
    "two_level_allreduce degradations to flat allreduce (non-power-of-two "
    "cross-host group or trivial topology); counted per compiled program, "
    "not per step.")


def on() -> bool:
    """The hot-path gate: one attribute read."""
    return registry.enabled


def _itemsize(dtype) -> int:
    """Bytes an element of ``dtype`` takes: a torch dtype, a numpy dtype
    or either's name (``"bfloat16"``, ``"torch.float8_e4m3fn"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        t = getattr(torch, str(dtype).replace("torch.", ""), None)
        if isinstance(t, torch.dtype):
            return t.itemsize
        raise


def payload_bytes(shape, dtype) -> int:
    """Best-effort byte count of one rank's payload; never raises (the
    metrics plane must not take down a dispatch over an exotic dtype).
    Takes torch dtypes as well as numpy's, bf16 and the float8 types
    with torch's sizes."""
    try:
        n = 1
        for d in shape:
            n *= int(d)
        return n * _itemsize(dtype)
    except Exception:  # noqa: BLE001
        return 0


def record_eager(op: str, nbytes: int, negotiate_s: float,
                 total_s: float) -> None:
    """One eager collective dispatch (the reference's
    ``eager._dispatch_guard``)."""
    EAGER_CALLS.labels(op).inc()
    if nbytes:
        EAGER_BYTES.labels(op).inc(nbytes)
        # dispatch cost density (µs per MiB moved)
        if timeseries.on():
            timeseries.record(timeseries.DISPATCH_US_PER_MIB,
                              total_s * 1e6 / (nbytes / 2**20))
    EAGER_SECONDS.labels(op).observe(total_s)
    NEGOTIATE_SECONDS.labels(op).observe(negotiate_s)


def record_host(op: str, transport: str, nbytes: int, seconds: float) -> None:
    """One host-plane collective (``eager.process_*``, the frontend's
    handles)."""
    HOST_CALLS.labels(op, transport).inc()
    if nbytes:
        HOST_BYTES.labels(op, transport).inc(nbytes)
    HOST_SECONDS.labels(transport).observe(seconds)


_gate = threading.local()


@contextlib.contextmanager
def traced_recording(record: bool):
    """Inside a train step's program: whether this execution records the
    traced-collective inventory (True once a capture, see the module
    docstring).  Outside any such block every call records."""
    prev = getattr(_gate, "record", None)
    _gate.record = bool(record)
    try:
        yield
    finally:
        _gate.record = prev


def _recording() -> bool:
    return registry.enabled and getattr(_gate, "record", None) is not False


def record_traced(op: str, tensor) -> None:
    """A collective issued by ``ops/collectives.py`` — once a capture
    inside a train step, never per replay."""
    if not _recording():
        return
    try:
        TRACED_CALLS.labels(op).inc()
        nb = payload_bytes(getattr(tensor, "shape", ()),
                           getattr(tensor, "dtype", "float32"))
        if nb:
            TRACED_BYTES.labels(op).inc(nb)
    except Exception:  # noqa: BLE001 — a collective must never fail on metrics
        pass


def record_traced_group(op: str, group: str) -> None:
    """Group-labelled traced-collective inventory (two-level local/cross
    stages, process sets) on its own counter, so the user-visible per-op
    call (counted by :func:`record_traced`) is not counted twice.
    ``group`` is the group *family* (``local`` / ``cross`` /
    ``process_set:…``)."""
    if not _recording():
        return
    try:
        TRACED_GROUP_CALLS.labels(op, group).inc()
    except Exception:  # noqa: BLE001 — a collective must never fail on metrics
        pass


def dump_metrics_json(path: str) -> None:
    """Write the per-rank snapshot (called by timeline shutdown so
    ``metrics.json`` lands next to ``comm.json``)."""
    registry.dump(path)


from .push import (  # noqa: E402,F401  (import after instruments exist)
    start_pusher,
    start_pusher_from_env,
    stop_pusher,
)
from . import timeseries  # noqa: E402  (ring-buffer history plane)
