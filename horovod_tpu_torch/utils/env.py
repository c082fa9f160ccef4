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
HVD_PROFILE_HBM_GBPS = "HVD_PROFILE_HBM_GBPS"          # device memory bandwidth for roofline math, GB/s
# process identity, as set by the launcher (the reference's core.init reads
# the same three): coordinator host:port, world size, this process's rank
HVD_COORDINATOR_ADDR = "HVD_COORDINATOR_ADDR"
HVD_NUM_PROCESSES = "HVD_NUM_PROCESSES"
HVD_PROCESS_ID = "HVD_PROCESS_ID"
HVD_LOCAL_SIZE = "HVD_LOCAL_SIZE"                      # processes (cards) per host; default: the world
HVD_START_TIMEOUT = "HVD_START_TIMEOUT"                # seconds a rank waits for the others at init

# -- knobs of features still to be ported: refused when switched on ----------
HVD_COMPRESSION = "HVD_COMPRESSION"
HVD_COMPRESSION_ERROR_FEEDBACK = "HVD_COMPRESSION_ERROR_FEEDBACK"
HVD_TWO_LEVEL_ALLREDUCE = "HVD_TWO_LEVEL_ALLREDUCE"
HVD_AUTOTUNE = "HVD_AUTOTUNE"
HVD_AUTOTUNE_PROFILE_GUIDED = "HVD_AUTOTUNE_PROFILE_GUIDED"
HVD_PROFILE = "HVD_PROFILE"
HVD_REMAT_POLICY = "HVD_REMAT_POLICY"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024  # 64 MiB, reference common.h:69
FUSION_BUFFER_ATOMIC_UNIT = 64                     # reference common.h:94
DEFAULT_START_TIMEOUT_SECONDS = 60.0               # rendezvous bound (core.init)
DEFAULT_LOSS_FETCH_STEPS = 16                      # trailing loss-fetch cadence (training.py)


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
