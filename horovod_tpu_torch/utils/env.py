"""Environment-variable knobs the port reads, and their parsing.

The port's own copy of the part of ``horovod_tpu/utils/env.py`` the
port needs: the same knob names and parsing rules, so one environment
drives either package.  The defaults are the reference's, but the link
model's, which are the H100's (``timeline/comm_report.py``).  Knobs of
features that have not been ported yet are listed too, because the port
refuses them when they are set instead of ignoring them.
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
HVD_METRICS_KV_ADDR = "HVD_METRICS_KV_ADDR"            # launcher rendezvous host the pushes go to
HVD_METRICS_KV_PORT = "HVD_METRICS_KV_PORT"            # launcher rendezvous port
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
HVD_TIMESERIES_FLUSH_SECONDS = "HVD_TIMESERIES_FLUSH_SECONDS"  # time-series flush interval (default HVD_METRICS_PUSH_SECONDS)
# flight recorder (observe/events.py)
HVD_EVENTS = "HVD_EVENTS"                              # 0 disables the recorder (default on)
HVD_EVENTS_RING_CAP = "HVD_EVENTS_RING_CAP"            # per-process ring capacity, events (default 1024)
HVD_EVENTS_FLUSH_SECONDS = "HVD_EVENTS_FLUSH_SECONDS"  # worker-side flusher cadence (default HVD_METRICS_PUSH_SECONDS or 5)
HVD_EVENTS_SERVER_CAP = "HVD_EVENTS_SERVER_CAP"        # server-side retained event cap per source
# the replay engine (timeline/replay/): the clock handshake against the
# rendezvous server, and the α–β link model's overrides (defaults:
# timeline/comm_report.py, NVLink 4 and NDR InfiniBand)
HVD_REPLAY_CLOCK_SYNC = "HVD_REPLAY_CLOCK_SYNC"        # 0 skips the init-time clock handshake
HVD_REPLAY_CLOCK_SAMPLES = "HVD_REPLAY_CLOCK_SAMPLES"  # handshake round trips (default 8)
HVD_REPLAY_ICI_GBPS = "HVD_REPLAY_ICI_GBPS"            # what-if intra-node link bandwidth, GB/s (default 450)
HVD_REPLAY_HOP_US = "HVD_REPLAY_HOP_US"                # what-if intra-node per-hop latency, µs (default 0.6)
HVD_REPLAY_DCN_GBPS = "HVD_REPLAY_DCN_GBPS"            # two-level what-if cross-node bandwidth, GB/s (default 50)
HVD_REPLAY_DCN_HOP_US = "HVD_REPLAY_DCN_HOP_US"        # two-level what-if cross-node hop latency, µs (default 2.7)
HVD_REPLAY_LOCAL_SIZE = "HVD_REPLAY_LOCAL_SIZE"        # two-level what-if group size (default HVD_LOCAL_SIZE)
HVD_PROJECT_MODE = "HVD_PROJECT_MODE"                  # chain replication: distribution|slowest (default distribution)

# -- the tuners (optim/autotune.py, optim/profile_guided.py) and the loader --
HVD_AUTOTUNE = "HVD_AUTOTUNE"                          # 1 runs the GP autotuner in make_train_step
HVD_AUTOTUNE_LOG = "HVD_AUTOTUNE_LOG"                  # CSV of the GP's samples
HVD_AUTOTUNE_WARMUP_SAMPLES = "HVD_AUTOTUNE_WARMUP_SAMPLES"  # samples discarded first (default 3)
HVD_AUTOTUNE_STEPS_PER_SAMPLE = "HVD_AUTOTUNE_STEPS_PER_SAMPLE"  # steps a sample (default 10)
HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = "HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"  # samples before freezing (default 10 a category)
HVD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE = "HVD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"  # GP noise (default 0.8)
HVD_AUTOTUNE_PYTHON = "HVD_AUTOTUNE_PYTHON"            # 1 keeps the NumPy tuner over the native one
HVD_AUTOTUNE_COMPUTE = "HVD_AUTOTUNE_COMPUTE"          # 1 lets the GP rotate the compute knobs too
HVD_AUTOTUNE_PROFILE_GUIDED = "HVD_AUTOTUNE_PROFILE_GUIDED"  # 1 enables the profile-guided loop
HVD_AUTOTUNE_WINDOW_STEPS = "HVD_AUTOTUNE_WINDOW_STEPS"      # steps per measure/verify window (default 20)
HVD_AUTOTUNE_GUARD_BAND_PCT = "HVD_AUTOTUNE_GUARD_BAND_PCT"  # realized-vs-predicted tolerance (default 10)
HVD_AUTOTUNE_ROLLBACK = "HVD_AUTOTUNE_ROLLBACK"              # 0 keeps regressed plans (default 1)
HVD_AUTOTUNE_WARM_START = "HVD_AUTOTUNE_WARM_START"          # 0 skips the α–β GP prior (default 1)
HVD_AUTOTUNE_CYCLE_FLUSH_STEPS = "HVD_AUTOTUNE_CYCLE_FLUSH_STEPS"  # re-plan a verified plan every N steps (0 = pin forever)
HVD_PREFETCH_DEPTH = "HVD_PREFETCH_DEPTH"              # device prefetch queue depth in data/loader.py (default 2; 0 disables)

# -- the rendezvous plane and the launcher (run/, runtime/, elastic/) --------
# per-slot topology the launcher exports (the reference's HOROVOD_RANK/SIZE/...)
HVD_RANK = "HVD_RANK"
HVD_SIZE = "HVD_SIZE"
HVD_LOCAL_RANK = "HVD_LOCAL_RANK"
HVD_CROSS_RANK = "HVD_CROSS_RANK"
HVD_CROSS_SIZE = "HVD_CROSS_SIZE"
# "external": the launcher serves the job's TCPStore at HVD_COORDINATOR_ADDR
# and every rank joins it as a client (run/run.py); unset: rank 0 serves it
HVD_COORDINATOR_SERVER = "HVD_COORDINATOR_SERVER"
HVD_CONTROLLER = "HVD_CONTROLLER"                      # auto|xla|native eager control plane
HVD_CPU_OPERATIONS = "HVD_CPU_OPERATIONS"
HVD_NETWORK_INTERFACE = "HVD_NETWORK_INTERFACE"        # NIC names the host data plane advertises on
HVD_CYCLE_TIME = "HVD_CYCLE_TIME"                      # ms; HOROVOD_CYCLE_TIME
HVD_CACHE_CAPACITY = "HVD_CACHE_CAPACITY"
HVD_RING_MIN_BYTES = "HVD_RING_MIN_BYTES"              # host-plane ring/star crossover
HVD_HIERARCHICAL_ALLGATHER = "HVD_HIERARCHICAL_ALLGATHER"
HVD_STALL_CHECK_DISABLE = "HVD_STALL_CHECK_DISABLE"
HVD_STALL_CHECK_TIME_SECONDS = "HVD_STALL_CHECK_TIME_SECONDS"
HVD_STALL_SHUTDOWN_TIME_SECONDS = "HVD_STALL_SHUTDOWN_TIME_SECONDS"
# failure-domain runtime (elastic/heartbeat.py, elastic/abort.py, run/run.py)
HVD_HEARTBEAT_INTERVAL_SECONDS = "HVD_HEARTBEAT_INTERVAL_SECONDS"  # lease renewal (default 2)
HVD_HEARTBEAT_DISABLE = "HVD_HEARTBEAT_DISABLE"        # 1 turns the lease/abort plane off
HVD_TERM_GRACE_SECONDS = "HVD_TERM_GRACE_SECONDS"      # SIGTERM→SIGKILL escalation grace (default 5)
HVD_HTTP_RETRIES = "HVD_HTTP_RETRIES"                  # rendezvous HTTP retry budget (default 2)
HVD_HTTP_BACKOFF_MS = "HVD_HTTP_BACKOFF_MS"            # base retry backoff, ms (default 50)
HVD_HTTP_KEEPALIVE = "HVD_HTTP_KEEPALIVE"              # 0 disables pooled keep-alive connections (debug)
HVD_RESTART_COUNT = "HVD_RESTART_COUNT"                # incarnation index set by the supervisor
HVD_RESTART_BACKOFF_SECONDS = "HVD_RESTART_BACKOFF_SECONDS"  # restart backoff base (default 1)
HVD_ELASTIC = "HVD_ELASTIC"                            # 1 = elastic driver supervises the job (not ported)
HVD_ELASTIC_WORKER_ID = "HVD_ELASTIC_WORKER_ID"        # stable worker identity across epochs
HVD_ELASTIC_MIN_NP = "HVD_ELASTIC_MIN_NP"              # floor world size before giving up (default 1)
HVD_SERVE = "HVD_SERVE"                                # 1 = serving plane on (not ported)
HVD_SERVE_MAX_BATCH = "HVD_SERVE_MAX_BATCH"            # batcher admits up to this many requests (default 8)
HVD_SERVE_MAX_WAIT_MS = "HVD_SERVE_MAX_WAIT_MS"        # flush deadline from first admitted request (default 5)
HVD_SERVE_SLO_MS = "HVD_SERVE_SLO_MS"                  # p99 latency objective (default 100)
HVD_SERVE_AUTOSCALE = "HVD_SERVE_AUTOSCALE"            # 1 = autoscaler drives the elastic driver
HVD_WATCH = "HVD_WATCH"                                # the launcher-side watchdog (not ported: a true value raises)
HVD_WATCH_ARM = "HVD_WATCH_ARM"                        # 0 stops arm records from moving trace windows (default 1)
# the KV plane (run/store.py, run/http_server.py, run/relay.py)
HVD_CP_SHARDS = "HVD_CP_SHARDS"                        # KV store shard count (default 8)
HVD_RENDEZVOUS_ADDRS = "HVD_RENDEZVOUS_ADDRS"          # ordered host:port,host:port failover list (primary first)
HVD_RENDEZVOUS_JOURNAL = "HVD_RENDEZVOUS_JOURNAL"      # mutation-journal path; enables warm-standby replay
HVD_RELAY = "HVD_RELAY"                                # 1 = local-rank-0 runs the per-host relay daemon
HVD_RELAY_PORT = "HVD_RELAY_PORT"                      # relay listen port (default 0 = ephemeral)
HVD_RELAY_FLUSH_MS = "HVD_RELAY_FLUSH_MS"              # relay upstream batch-flush cadence, ms (default 500)
HVD_TIMESERIES_SERVER_CAP = "HVD_TIMESERIES_SERVER_CAP"  # per-series sample cap in the server's per-rank doc (default 2048)

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
DEFAULT_AUTOTUNE_WINDOW_STEPS = 20                 # profile-guided measure/verify window
DEFAULT_AUTOTUNE_GUARD_BAND_PCT = 10.0             # rollback when realized lags predicted by more
DEFAULT_AUTOTUNE_CYCLE_FLUSH_STEPS = 0             # verified plans pinned forever unless set
DEFAULT_DCN_GBPS = 50.0                            # cross-node link, GB/s (NDR InfiniBand, comm_report.py)
DEFAULT_DCN_HOP_US = 2.7                           # cross-node hop latency, µs (NCCL's ring model, comm_report.py)
DEFAULT_PREFETCH_DEPTH = 2                         # device prefetch queue depth (data/loader.py)
DEFAULT_STALL_WARNING_SECONDS = 60.0               # reference stall_inspector.h:72
DEFAULT_HEARTBEAT_INTERVAL_SECONDS = 2.0           # elastic/heartbeat.py lease renewal
DEFAULT_TERM_GRACE_SECONDS = 5.0                   # run/run.py SIGTERM→SIGKILL grace
DEFAULT_HTTP_RETRIES = 2                           # run/http_client.py retry budget
DEFAULT_HTTP_BACKOFF_MS = 50.0                     # run/http_client.py backoff base
DEFAULT_RESTART_BACKOFF_SECONDS = 1.0              # run/run.py restart backoff base
DEFAULT_CP_SHARDS = 8                              # run/store.py KV shard count
DEFAULT_RELAY_FLUSH_MS = 500.0                     # run/relay.py upstream batch cadence
DEFAULT_TIMESERIES_SERVER_CAP = 2048               # per-series cap in the server's per-rank doc


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
