"""Environment-variable knobs the port reads, and their parsing.

The port's own copy of the part of ``horovod_tpu/utils/env.py`` this
slice needs: the same knob names, defaults and parsing rules, so one
environment drives either package.  Knobs of features that have not been
ported yet are listed too, because the port refuses them when they are
set instead of ignoring them (``training.make_train_step``).
"""

from __future__ import annotations

import os
from typing import Optional

# -- knobs the slice reads ---------------------------------------------------
HVD_FUSION_THRESHOLD = "HVD_FUSION_THRESHOLD"          # bytes per fused gradient bucket
HVD_FUSED_OPTIMIZER = "HVD_FUSED_OPTIMIZER"            # 0 forces the per-leaf update path
HVD_LOSS_FETCH_STEPS = "HVD_LOSS_FETCH_STEPS"          # trailing loss fetch cadence (0 never fetches)
HVD_LOG_LEVEL = "HVD_LOG_LEVEL"
HVD_LOG_HIDE_TIME = "HVD_LOG_HIDE_TIME"
HVD_PEAK_FLOPS = "HVD_PEAK_FLOPS"                      # per-card peak FLOP/s for every MFU number
HVD_PROFILE_HBM_GBPS = "HVD_PROFILE_HBM_GBPS"          # device memory bandwidth for roofline math, GB/s (default: utils/flops.py's card)
# process identity, as set by the launcher (the reference's core.init reads
# the same three): coordinator host:port, world size, this process's rank
HVD_COORDINATOR_ADDR = "HVD_COORDINATOR_ADDR"
HVD_NUM_PROCESSES = "HVD_NUM_PROCESSES"
HVD_PROCESS_ID = "HVD_PROCESS_ID"
HVD_LOCAL_SIZE = "HVD_LOCAL_SIZE"                      # processes (cards) per host; default: the world
HVD_START_TIMEOUT = "HVD_START_TIMEOUT"                # seconds a rank waits for the others at init
HVD_COMPRESSION = "HVD_COMPRESSION"                    # none|bf16|int8|fp8|fp8_e5m2 wire format
HVD_COMPRESSION_ERROR_FEEDBACK = "HVD_COMPRESSION_ERROR_FEEDBACK"  # 0 drops the residual carry (default 1)
HVD_COMPRESSION_GUARD_STEPS = "HVD_COMPRESSION_GUARD_STEPS"  # residual-norm check cadence (default 25; 0 off)
HVD_COMPRESSION_GUARD_FACTOR = "HVD_COMPRESSION_GUARD_FACTOR"  # divergence = norm > factor x baseline (default 10)
HVD_TWO_LEVEL_ALLREDUCE = "HVD_TWO_LEVEL_ALLREDUCE"    # 1 = compressed two-level gradient path
HVD_HIERARCHICAL_ALLREDUCE = "HVD_HIERARCHICAL_ALLREDUCE"  # 1 = the two-level allreduce by default

HVD_REMAT_POLICY = "HVD_REMAT_POLICY"                  # none|full|dots rematerialization

# -- the trace plane: timeline, recorder, profiler, metrics, events ----------
HVD_TIMELINE = "HVD_TIMELINE"                          # trace output dir
HVD_TIMELINE_MARK_CYCLES = "HVD_TIMELINE_MARK_CYCLES"  # CYCLE_START instants
HVD_TIMELINE_PYTHON = "HVD_TIMELINE_PYTHON"            # 1 forces the Python writer
HVD_TRACE_START_STEP = "HVD_TRACE_START_STEP"          # fork: BYTEPS_TRACE_START_STEP
HVD_TRACE_END_STEP = "HVD_TRACE_END_STEP"              # fork: BYTEPS_TRACE_END_STEP
HVD_TRACE_ON = "HVD_TRACE_ON"                          # fork: BYTEPS_TRACE_ON
HVD_TRACE_DIR = "HVD_TRACE_DIR"                        # fork: BYTEPS_TRACE_DIR
# compute-anatomy profiler (timeline/profiler.py): a step window in which
# the train step runs its four blocks one by one, each synced and timed
HVD_PROFILE = "HVD_PROFILE"                            # 1 enables the profiled step window
HVD_PROFILE_START_STEP = "HVD_PROFILE_START_STEP"      # window start (default HVD_TRACE_START_STEP or 1)
HVD_PROFILE_END_STEP = "HVD_PROFILE_END_STEP"          # window end (default start + 2: a 3-step window)
HVD_PROFILE_XLA = "HVD_PROFILE_XLA"                    # 1 also captures a torch.profiler (CUPTI) trace into <rank>/cuda_trace
HVD_PROFILE_GAP_THRESHOLD_US = "HVD_PROFILE_GAP_THRESHOLD_US"  # inter-dispatch gap flagged as a host-gap span past this (default 25)
# metrics plane (metrics/): the registry, its time series and the pushes
HVD_METRICS = "HVD_METRICS"                            # 0 disables the registry
HVD_METRICS_KV_ADDR = "HVD_METRICS_KV_ADDR"            # launcher rendezvous host (pushes: not ported)
HVD_METRICS_KV_PORT = "HVD_METRICS_KV_PORT"            # launcher rendezvous port (pushes: not ported)
HVD_METRICS_SECRET = "HVD_METRICS_SECRET"              # hex HMAC secret for pushes
HVD_METRICS_PUSH_SECONDS = "HVD_METRICS_PUSH_SECONDS"  # push interval (default 5)
HVD_METRICS_DELTA = "HVD_METRICS_DELTA"                # 0 forces full metric snapshots every push
HVD_METRICS_BUCKET_FLOOR = "HVD_METRICS_BUCKET_FLOOR"  # first latency bucket edge, seconds (default 1e-4)
HVD_METRICS_BUCKET_FACTOR = "HVD_METRICS_BUCKET_FACTOR"  # geometric growth per bucket (default 2)
HVD_METRICS_BUCKET_COUNT = "HVD_METRICS_BUCKET_COUNT"  # finite bucket count (default 18)
HVD_SERVE_LATENCY_BUCKET_FLOOR = "HVD_SERVE_LATENCY_BUCKET_FLOOR"  # serving histogram floor, seconds (default 2.5e-4)
HVD_TIMESERIES = "HVD_TIMESERIES"                      # 0 disables the ring-buffer history
HVD_TIMESERIES_CAP = "HVD_TIMESERIES_CAP"              # raw-tier ring capacity, samples (default 512)
HVD_TIMESERIES_TIERS = "HVD_TIMESERIES_TIERS"          # downsampling tiers incl. raw (default 3)
HVD_TIMESERIES_FACTOR = "HVD_TIMESERIES_FACTOR"        # per-tier downsample factor (default 8)
HVD_TIMESERIES_FLUSH_SECONDS = "HVD_TIMESERIES_FLUSH_SECONDS"  # flush interval (pushes: not ported)
# flight recorder (observe/events.py)
HVD_EVENTS = "HVD_EVENTS"                              # 0 disables the recorder (default on)
HVD_EVENTS_RING_CAP = "HVD_EVENTS_RING_CAP"            # per-process ring capacity, events (default 1024)
HVD_EVENTS_FLUSH_SECONDS = "HVD_EVENTS_FLUSH_SECONDS"  # worker-side flusher cadence (pushes: not ported)
HVD_EVENTS_SERVER_CAP = "HVD_EVENTS_SERVER_CAP"        # server-side retained event cap per source
# the replay engine's clock handshake against the rendezvous server
HVD_REPLAY_CLOCK_SYNC = "HVD_REPLAY_CLOCK_SYNC"        # 0 skips the init-time clock handshake
HVD_REPLAY_CLOCK_SAMPLES = "HVD_REPLAY_CLOCK_SAMPLES"  # handshake round trips (default 8)

# -- knobs of features still to be ported: refused when switched on ----------
HVD_AUTOTUNE = "HVD_AUTOTUNE"
HVD_AUTOTUNE_PROFILE_GUIDED = "HVD_AUTOTUNE_PROFILE_GUIDED"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024  # 64 MiB, reference common.h:69
FUSION_BUFFER_ATOMIC_UNIT = 64                     # reference common.h:94
DEFAULT_START_TIMEOUT_SECONDS = 60.0               # rendezvous bound (core.init)
DEFAULT_LOSS_FETCH_STEPS = 16                      # trailing loss-fetch cadence (training.py)
DEFAULT_COMPRESSION_GUARD_STEPS = 25               # error-feedback residual-norm check cadence
DEFAULT_COMPRESSION_GUARD_FACTOR = 10.0            # residual divergence threshold (x baseline)
DEFAULT_PROFILE_STEPS = 3                          # profiler window length when no end step is configured
DEFAULT_PROFILE_GAP_THRESHOLD_US = 25.0            # host-gap span flagging threshold
DEFAULT_PROFILE_HOST_BOUND_FRACTION = 0.2          # step verdict flips to host-bound past this gap share
DEFAULT_METRICS_BUCKET_FLOOR = 1e-4                # first latency bucket edge, seconds
DEFAULT_METRICS_BUCKET_FACTOR = 2.0                # geometric bucket growth
DEFAULT_METRICS_BUCKET_COUNT = 18                  # finite bucket count
DEFAULT_SERVE_LATENCY_BUCKET_FLOOR = 2.5e-4        # serving histogram floor, seconds
DEFAULT_TIMESERIES_CAP = 512                       # metrics/timeseries.py raw-tier ring capacity
DEFAULT_TIMESERIES_TIERS = 3                       # downsampling tiers including the raw tier
DEFAULT_TIMESERIES_FACTOR = 8                      # per-tier downsample factor
DEFAULT_EVENTS_RING_CAP = 1024                     # observe/events.py per-process ring capacity
DEFAULT_EVENTS_FLUSH_SECONDS = 5.0                 # worker-side event flusher cadence
DEFAULT_EVENTS_SERVER_CAP = 4096                   # server-side retained events per source


def get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        return default


def get_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


def parse_bool(value: Optional[str], default: bool = False) -> bool:
    """The one truthiness rule for HVD_* flags."""
    if value is None or value == "":
        return default
    return value.strip().lower() in ("1", "true", "yes", "on")


def get_bool(name: str, default: bool = False) -> bool:
    return parse_bool(os.environ.get(name), default)


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    v = os.environ.get(name)
    return v if v not in (None, "") else default


def fusion_threshold_bytes() -> int:
    n = get_int(HVD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES)
    # Round up to the atomic unit so fused buffers stay divisible for
    # scatter-style ops (reference controller.cc:357-375).
    if n % FUSION_BUFFER_ATOMIC_UNIT:
        n = (n // FUSION_BUFFER_ATOMIC_UNIT + 1) * FUSION_BUFFER_ATOMIC_UNIT
    return n
