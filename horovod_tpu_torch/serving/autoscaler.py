"""Traffic-driven autoscaling policy + the elastic-driver binding: the
port of ``horovod_tpu/serving/autoscaler.py`` (its decisions are the
reference's on the same inputs).

The serving plane reuses the versioned-epoch membership machinery
(elastic/driver.py) to scale with *load* instead of failures:

* :class:`AutoscalePolicy` is the pure decision function the tests pin:
  **grow** when queue depth per replica stays above
  ``HVD_SERVE_QUEUE_HIGH`` — or windowed p99 stays above
  ``HVD_SERVE_SLO_MS`` — for ``HVD_SERVE_HYSTERESIS_TICKS``
  consecutive ticks; **shrink** when depth per replica stays at or
  below ``HVD_SERVE_QUEUE_LOW`` with p99 inside the SLO for the same
  run of ticks.  A ``HVD_SERVE_COOLDOWN_SECONDS`` refractory period
  after every action plus the two independent tick counters is the
  hysteresis that keeps the world from flapping.
* :class:`ServingAutoscaler` binds the policy to a live
  :class:`~horovod_tpu_torch.elastic.driver.ElasticDriver` and
  :class:`~horovod_tpu_torch.serving.broker.RequestBroker`: the driver calls
  :meth:`tick` from its supervision poll (stable epochs only), and a
  decision becomes a membership epoch — grow admits a held spare
  (``driver.admit_spare``), shrink runs the lossless drain handshake
  (``driver.remove(..., drain=True)``) so no in-flight request is
  dropped across the transition.
* The digital twin's serving hook
  (:func:`~horovod_tpu_torch.utils.slo.serving_slo_headroom`) prices a capacity change BEFORE it is taken: a
  shrink whose projected p99 at one fewer replica would breach the SLO
  is held (the predictive guard, ``HVD_PROJECT_SLO_GUARD=0`` disables),
  and the per-direction projected headroom is surfaced on
  ``GET /serving``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)


class AutoscalePolicy:
    """Hysteresis-damped threshold policy; pure and clock-injectable."""

    def __init__(self, *, queue_high: Optional[float] = None,
                 queue_low: Optional[float] = None,
                 slo_ms: Optional[float] = None,
                 hysteresis_ticks: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.queue_high = float(
            queue_high if queue_high is not None
            else env_util.get_float(env_util.HVD_SERVE_QUEUE_HIGH,
                                    env_util.DEFAULT_SERVE_QUEUE_HIGH))
        self.queue_low = float(
            queue_low if queue_low is not None
            else env_util.get_float(env_util.HVD_SERVE_QUEUE_LOW,
                                    env_util.DEFAULT_SERVE_QUEUE_LOW))
        self.slo_ms = float(
            slo_ms if slo_ms is not None
            else env_util.get_float(env_util.HVD_SERVE_SLO_MS,
                                    env_util.DEFAULT_SERVE_SLO_MS))
        self.hysteresis_ticks = int(
            hysteresis_ticks if hysteresis_ticks is not None
            else env_util.get_int(env_util.HVD_SERVE_HYSTERESIS_TICKS,
                                  env_util.DEFAULT_SERVE_HYSTERESIS_TICKS))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else env_util.get_float(env_util.HVD_SERVE_COOLDOWN_SECONDS,
                                    env_util.DEFAULT_SERVE_COOLDOWN_SECONDS))
        self.min_replicas = int(
            min_replicas if min_replicas is not None
            else env_util.get_int(env_util.HVD_SERVE_MIN_REPLICAS,
                                  env_util.DEFAULT_SERVE_MIN_REPLICAS))
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else env_util.get_int(env_util.HVD_SERVE_MAX_REPLICAS, 0))
        self.clock = clock
        self._over_ticks = 0
        self._idle_ticks = 0
        self._last_action_t: Optional[float] = None

    def reset(self) -> None:
        self._over_ticks = 0
        self._idle_ticks = 0
        self._last_action_t = None

    def cancel_last_action(self) -> None:
        """A decision this policy issued could not actually be executed
        (e.g. every held spare turned out blocklisted): lift the
        cooldown it started, so real capacity changes aren't delayed by
        a no-op."""
        self._last_action_t = None

    def in_cooldown(self) -> bool:
        return (self._last_action_t is not None
                and self.clock() - self._last_action_t < self.cooldown_s)

    def decide(self, *, queue_depth: int, p99_ms: Optional[float],
               replicas: int, spares: int = 0) -> str:
        """One tick: returns ``"grow"``, ``"shrink"``, or ``"hold"``.

        Tick counters advance even inside the cooldown (so a breach
        that SPANS the cooldown acts immediately after it), but no
        action fires until the cooldown elapses."""
        replicas = max(int(replicas), 1)
        per_replica = queue_depth / replicas
        slo_breach = p99_ms is not None and p99_ms > self.slo_ms
        overloaded = per_replica > self.queue_high or slo_breach
        idle = (per_replica <= self.queue_low
                and (p99_ms is None or p99_ms <= self.slo_ms))
        # the two counters are exclusive: a tick feeds one and zeroes
        # the other, so one noisy sample restarts the opposing run
        if overloaded:
            self._over_ticks += 1
            self._idle_ticks = 0
        elif idle:
            self._idle_ticks += 1
            self._over_ticks = 0
        else:
            self._over_ticks = 0
            self._idle_ticks = 0
        if self.in_cooldown():
            return "hold"
        if self._over_ticks >= self.hysteresis_ticks:
            can_grow = spares > 0 and (
                self.max_replicas <= 0 or replicas < self.max_replicas)
            if can_grow:
                self._last_action_t = self.clock()
                self._over_ticks = 0
                return "grow"
            return "hold"
        if self._idle_ticks >= self.hysteresis_ticks \
                and replicas > self.min_replicas:
            self._last_action_t = self.clock()
            self._idle_ticks = 0
            return "shrink"
        return "hold"


class ServingAutoscaler:
    """Driver-attached autoscaler: ticks read the broker, decisions
    commit membership epochs.

    ``pick_victim(driver) -> worker_id`` chooses the scale-down target;
    the default drains the most recently admitted non-initial worker
    (LIFO — scale back down to the core fleet first), falling back to
    the highest-ranked worker, and never rank 0."""

    def __init__(self, driver, broker, policy: Optional[AutoscalePolicy]
                 = None, *, pick_victim: Optional[Callable] = None,
                 headroom_fn: Optional[Callable] = None) -> None:
        self.driver = driver
        self.broker = broker
        self.policy = policy or AutoscalePolicy()
        self.pick_victim = pick_victim or self._default_victim
        # SLO-headroom hook (the digital twin's serving projection,
        # utils/slo.py — dependency-free math, no replay-stack import
        # on the serving path): projected slo − p99 after a replica
        # delta; injectable for tests
        if headroom_fn is None:
            from ..utils.slo import serving_slo_headroom

            headroom_fn = serving_slo_headroom
        self.headroom_fn = headroom_fn
        self.slo_guard = env_util.get_bool(
            env_util.HVD_PROJECT_SLO_GUARD, True)
        self._last_headroom: dict = {}
        self.events = []  # (direction, worker, epoch) history
        self.event_times: List[float] = []  # monotonic, one an event

    @staticmethod
    def _default_victim(driver) -> Optional[str]:
        candidates = [w for w in driver.world[1:]
                      if w not in driver.finished]
        if not candidates:
            return None
        external = [w for w in candidates if w not in driver.initial]
        return (external or candidates)[-1]

    def tick(self) -> str:
        """One autoscale evaluation (called by ``ElasticDriver.poll``
        on stable epochs).  Returns the decision taken."""
        stats = self.broker.window_stats()
        self._export_gauges(stats)
        replicas = len(self.driver.world)
        self._last_headroom = self._headroom(stats, replicas)
        decision = self.policy.decide(
            queue_depth=stats["queue_depth"], p99_ms=stats["p99_ms"],
            replicas=replicas, spares=len(self.driver.spares))
        if decision == "shrink" and self.slo_guard:
            # predictive guard: don't take a shrink the twin already
            # prices as an SLO breach — the hysteresis counters would
            # only discover it after real requests paid for it
            headroom = self._last_headroom.get("shrink_ms")
            if headroom is not None and headroom < 0:
                log.warning(
                    "autoscale shrink held: projected p99 at %d replicas "
                    "breaches the %.1f ms SLO by %.1f ms "
                    "(HVD_PROJECT_SLO_GUARD=0 disables)",
                    replicas - 1, self.policy.slo_ms, -headroom)
                self.policy.cancel_last_action()
                return "hold"
        if decision == "grow":
            worker = self.driver.admit_spare(
                reason=f"autoscale grow: queue_depth="
                       f"{stats['queue_depth']} p99_ms={stats['p99_ms']}")
            if worker is None:
                # every held spare was unusable (blocklisted/already in
                # world): nothing changed, so no cooldown either
                self.policy.cancel_last_action()
                return "hold"
            self._record_event("grow", worker, stats)
        elif decision == "shrink":
            worker = self.pick_victim(self.driver)
            if worker is None:
                self.policy.cancel_last_action()
                return "hold"
            ok = self.driver.remove(
                worker,
                f"autoscale shrink: queue_depth={stats['queue_depth']} "
                f"p99_ms={stats['p99_ms']}", drain=True)
            if not ok:
                # min_np would be violated — not an error, just a floor
                self.driver.failed_reason = None
                self.policy.cancel_last_action()
                return "hold"
            self._record_event("shrink", worker, stats)
        return decision

    def _headroom(self, stats: dict, replicas: int) -> dict:
        """Projected SLO headroom (ms) per replica delta — None entries
        when the window carries no latency data or the hook fails (the
        twin must never take down the autoscaler)."""
        out = {}
        for key, delta in (("grow_ms", 1), ("shrink_ms", -1)):
            try:
                out[key] = self.headroom_fn(stats, replicas,
                                            self.policy.slo_ms, delta)
            except Exception:  # noqa: BLE001
                out[key] = None
        return out

    def _record_event(self, direction: str, worker: str,
                      stats: Optional[dict] = None) -> None:
        self.events.append((direction, worker, self.driver.epoch))
        self.event_times.append(time.monotonic())
        log.warning("autoscale %s: worker %s (epoch %d)", direction,
                    worker, self.driver.epoch)
        try:
            from .. import metrics

            if metrics.on():
                metrics.SERVE_AUTOSCALE_EVENTS.labels(direction).inc()
        except Exception:  # noqa: BLE001
            pass
        try:
            from ..observe import events as events_mod

            events_mod.record_event(
                f"autoscale.{direction}", severity="info",
                payload={
                    "worker": worker,
                    "epoch": self.driver.epoch,
                    "replicas": len(self.driver.world),
                    "queue_depth": (stats or {}).get("queue_depth"),
                    "p99_ms": (stats or {}).get("p99_ms"),
                    "slo_headroom_ms": dict(self._last_headroom),
                })
        except Exception:  # noqa: BLE001 — recording is best-effort
            pass

    def _export_gauges(self, stats: dict) -> None:
        try:
            from .. import metrics

            if metrics.on():
                if stats.get("p99_ms") is not None:
                    metrics.SERVE_P99_MS.set(stats["p99_ms"])
                    from ..metrics import timeseries

                    if timeseries.on():
                        timeseries.record(timeseries.SERVE_P99_MS_SERIES,
                                          stats["p99_ms"])
                metrics.SERVE_REPLICAS.set(len(self.driver.world))
        except Exception:  # noqa: BLE001
            pass

    def snapshot(self) -> dict:
        """State for ``GET /serving``."""
        p = self.policy
        return {
            "replicas": len(self.driver.world),
            "world": list(self.driver.world),
            "spares": list(self.driver.spares),
            "epoch": self.driver.epoch,
            "events": [{"direction": d, "worker": w, "epoch": e}
                       for d, w, e in self.events[-20:]],
            "policy": {
                "queue_high": p.queue_high, "queue_low": p.queue_low,
                "slo_ms": p.slo_ms,
                "hysteresis_ticks": p.hysteresis_ticks,
                "cooldown_s": p.cooldown_s,
                "min_replicas": p.min_replicas,
                "max_replicas": p.max_replicas,
            },
            "in_cooldown": p.in_cooldown(),
            # projected slo − p99 per replica delta:
            # what the last tick's window said a grow/shrink would buy
            "slo_headroom_ms": dict(self._last_headroom),
            "slo_guard": self.slo_guard,
        }
