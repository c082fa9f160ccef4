"""CLI-flag → env-var translation and YAML config override: the port of
``horovod_tpu/run/config_parser.py``, as it is.

Mirror of reference horovod/run/common/util/config_parser.py (+ the YAML
hook at run/run.py:446-449,609-613): every tunable exists in three layers
that must stay consistent — HVD_* env var (consumed by the runtime,
utils/env.py), launcher CLI flag (this file translates), optional
YAML config file (overrides CLI args before translation)."""

from __future__ import annotations

from typing import Dict

from ..utils import env as env_util

# YAML section/key → argparse dest (reference config_parser.py mapping)
_CONFIG_SCHEMA = {
    "params": {
        "fusion_threshold_mb": "fusion_threshold_mb",
        "cycle_time_ms": "cycle_time_ms",
        "cache_capacity": "cache_capacity",
        "hierarchical_allreduce": "hierarchical_allreduce",
        "hierarchical_allgather": "hierarchical_allgather",
        "ring_min_bytes": "ring_min_bytes",
        "compression": "compression",
        "no_error_feedback": "no_error_feedback",
        "two_level_allreduce": "two_level_allreduce",
    },
    "autotune": {
        "enabled": "autotune",
        "log_file": "autotune_log_file",
        "warmup_samples": "autotune_warmup_samples",
        "steps_per_sample": "autotune_steps_per_sample",
        "bayes_opt_max_samples": "autotune_bayes_opt_max_samples",
        "gaussian_process_noise": "autotune_gaussian_process_noise",
        "profile_guided": "profile_guided",
        "window_steps": "autotune_window_steps",
        "guard_band_pct": "autotune_guard_band_pct",
    },
    "timeline": {
        "filename": "timeline_filename",
        "mark_cycles": "timeline_mark_cycles",
    },
    "stall_check": {
        "disable": "no_stall_check",
        "warning_time_seconds": "stall_check_warning_time_seconds",
        "shutdown_time_seconds": "stall_check_shutdown_time_seconds",
    },
    "library_options": {
        "num_streams": "num_streams",
    },
    "serving": {
        "enabled": "serve",
        "max_batch": "serve_max_batch",
        "max_wait_ms": "serve_max_wait_ms",
        "slo_ms": "serve_slo_ms",
        "autoscale": "serve_autoscale",
    },
    "control_plane": {
        "relay": "relay",
        "journal": "journal",
    },
    "logging": {
        "level": "log_level",
        "hide_timestamp": "log_hide_timestamp",
    },
}


def set_args_from_config(args, config: dict, override_args: set) -> None:
    """Apply YAML config onto parsed args, skipping flags the user passed
    explicitly (reference config_parser.set_args_from_config)."""
    for section, keys in _CONFIG_SCHEMA.items():
        section_cfg = config.get(section) or {}
        for yaml_key, dest in keys.items():
            if yaml_key in section_cfg and dest not in override_args:
                setattr(args, dest, section_cfg[yaml_key])


def env_from_args(args) -> Dict[str, str]:
    """Translate parsed launcher args into the HVD_* env dict for workers
    (reference config_parser.set_env_from_args, called run/run.py:841)."""
    env: Dict[str, str] = {}

    def setb(name, val):
        if val:
            env[name] = "1"

    if getattr(args, "fusion_threshold_mb", None) is not None:
        env[env_util.HVD_FUSION_THRESHOLD] = str(
            int(args.fusion_threshold_mb * 1024 * 1024)
        )
    if getattr(args, "cycle_time_ms", None) is not None:
        env[env_util.HVD_CYCLE_TIME] = str(args.cycle_time_ms)
    if getattr(args, "cache_capacity", None) is not None:
        env[env_util.HVD_CACHE_CAPACITY] = str(args.cache_capacity)
    if getattr(args, "ring_min_bytes", None) is not None:
        env[env_util.HVD_RING_MIN_BYTES] = str(args.ring_min_bytes)
    setb(env_util.HVD_HIERARCHICAL_ALLREDUCE,
         getattr(args, "hierarchical_allreduce", False))
    setb(env_util.HVD_HIERARCHICAL_ALLGATHER,
         getattr(args, "hierarchical_allgather", False))
    if getattr(args, "compression", None):
        env[env_util.HVD_COMPRESSION] = str(args.compression)
    if getattr(args, "no_error_feedback", False):
        env[env_util.HVD_COMPRESSION_ERROR_FEEDBACK] = "0"
    setb(env_util.HVD_TWO_LEVEL_ALLREDUCE,
         getattr(args, "two_level_allreduce", False))

    setb(env_util.HVD_AUTOTUNE, getattr(args, "autotune", False))
    if getattr(args, "autotune", False):
        if getattr(args, "autotune_log_file", None):
            env[env_util.HVD_AUTOTUNE_LOG] = str(args.autotune_log_file)
        for attr, var in [
            ("autotune_warmup_samples", env_util.HVD_AUTOTUNE_WARMUP_SAMPLES),
            ("autotune_steps_per_sample",
             env_util.HVD_AUTOTUNE_STEPS_PER_SAMPLE),
            ("autotune_bayes_opt_max_samples",
             env_util.HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES),
            ("autotune_gaussian_process_noise",
             env_util.HVD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE),
        ]:
            if getattr(args, attr, None) is not None:
                env[var] = str(getattr(args, attr))

    setb(env_util.HVD_AUTOTUNE_PROFILE_GUIDED,
         getattr(args, "profile_guided", False))
    if getattr(args, "autotune_window_steps", None) is not None:
        env[env_util.HVD_AUTOTUNE_WINDOW_STEPS] = str(
            args.autotune_window_steps)
    if getattr(args, "autotune_guard_band_pct", None) is not None:
        env[env_util.HVD_AUTOTUNE_GUARD_BAND_PCT] = str(
            args.autotune_guard_band_pct)

    if getattr(args, "timeline_filename", None):
        env[env_util.HVD_TIMELINE] = str(args.timeline_filename)
        setb(env_util.HVD_TIMELINE_MARK_CYCLES,
             getattr(args, "timeline_mark_cycles", False))
    if getattr(args, "trace_start_step", None) is not None:
        env[env_util.HVD_TRACE_START_STEP] = str(args.trace_start_step)
    if getattr(args, "trace_end_step", None) is not None:
        env[env_util.HVD_TRACE_END_STEP] = str(args.trace_end_step)

    if getattr(args, "network_interface", None):
        env[env_util.HVD_NETWORK_INTERFACE] = str(args.network_interface)

    setb(env_util.HVD_STALL_CHECK_DISABLE,
         getattr(args, "no_stall_check", False))
    if getattr(args, "stall_check_warning_time_seconds", None) is not None:
        env[env_util.HVD_STALL_CHECK_TIME_SECONDS] = str(
            args.stall_check_warning_time_seconds
        )
    if getattr(args, "stall_check_shutdown_time_seconds", None) is not None:
        env[env_util.HVD_STALL_SHUTDOWN_TIME_SECONDS] = str(
            args.stall_check_shutdown_time_seconds
        )

    setb(env_util.HVD_SERVE, getattr(args, "serve", False))
    if getattr(args, "serve_max_batch", None) is not None:
        env[env_util.HVD_SERVE_MAX_BATCH] = str(args.serve_max_batch)
    if getattr(args, "serve_max_wait_ms", None) is not None:
        env[env_util.HVD_SERVE_MAX_WAIT_MS] = str(args.serve_max_wait_ms)
    if getattr(args, "serve_slo_ms", None) is not None:
        env[env_util.HVD_SERVE_SLO_MS] = str(args.serve_slo_ms)
    setb(env_util.HVD_SERVE_AUTOSCALE,
         getattr(args, "serve_autoscale", False))

    if getattr(args, "log_level", None):
        env[env_util.HVD_LOG_LEVEL] = str(args.log_level)
    setb(env_util.HVD_LOG_HIDE_TIME, getattr(args, "log_hide_timestamp", False))
    return env
