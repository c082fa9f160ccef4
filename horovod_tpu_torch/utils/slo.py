"""Projected-SLO arithmetic shared by the digital twin and the serving
autoscaler: the port of ``horovod_tpu/utils/slo.py``, kept as its own
copy (the port imports nothing of the JAX package).

Deliberately dependency-free: the serving plane consults these before
every autoscale decision, and pulling the whole timeline/replay stack
into that path would couple two planes that only share ten lines of
math.  The functions are re-exported from
``timeline.replay.projection`` as part of the twin's public API.
"""

from __future__ import annotations

from typing import Optional


def project_serving_p99(p50_ms: Optional[float], p99_ms: Optional[float],
                        replicas: int, delta: int = 1) -> Optional[float]:
    """Projected windowed p99 after adding (``delta > 0``) or removing
    (``delta < 0``) replicas: the latency tail above the p50 service
    floor is queueing delay, which scales inversely with the replica
    count at fixed offered load — ``p50 + (p99 − p50) · R / (R+Δ)``.
    Deliberately coarse (an M/M/c tail would need arrival-process
    assumptions the broker can't verify); it is the same lever
    direction the autoscaler acts on, priced before acting."""
    if p99_ms is None or replicas < 1 or replicas + delta < 1:
        return None
    p50 = p50_ms if p50_ms is not None else 0.0
    tail = max(p99_ms - p50, 0.0)
    return round(p50 + tail * replicas / (replicas + delta), 3)


def serving_slo_headroom(stats: dict, replicas: int, slo_ms: float,
                         delta: int = 1) -> Optional[float]:
    """``slo − projected_p99`` after a ``delta`` replica change (None
    when the window has no latency data): positive = the change keeps
    the SLO, negative = it breaches.  The autoscaler consults the
    ``delta=-1`` headroom before a shrink (docs/projection.md)."""
    proj = project_serving_p99(stats.get("p50_ms"), stats.get("p99_ms"),
                               replicas, delta)
    return None if proj is None else round(slo_ms - proj, 3)
