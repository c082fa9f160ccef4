"""Profile-guided tuning: close the replay→autotune loop — the port of
``horovod_tpu/optim/profile_guided.py``.

The replay engine (timeline/replay/) ranks what-ifs for a measured step
DAG and the autotuner (optim/autotune.py) moves the fusion knobs; this
module connects them into the loop the reference fork exists for
(dPRO auto-profiling layered on Horovod's ``parameter_manager``): every
trace window,

1. **analyze** — the stitcher + simulator replay *this job's* measured
   step DAG and emit ranked scenarios, the ``fuse_buckets_<k>`` ones
   carrying machine-readable plan payloads
   (timeline/replay/simulator.py ``bucket_plan_search``);
2. **plan** — :func:`plan_from_summary` translates the winning scenario
   into a :class:`FusionPlanSpec`: explicit per-tensor fusion buckets in
   dispatch order (the overlap schedule) plus a cycle/flush cadence;
3. **apply** — the plan goes live through the existing
   ``ParameterManager.on_update`` rebuild seam (``apply_plan`` pins the
   bucket vector; training.py rebuilds the step with ``named_buckets``,
   and its CUDA graph is captured again);
4. **verify** — the next window's realized step time is compared against
   the simulator's prediction; both sides are exported as the
   ``hvd_autotune_{predicted,realized}_speedup`` gauges and pushed, a
   record each, to the rendezvous ``GET /autotune`` table
   (``put_autotune_plan``), and a realized speedup more
   than ``HVD_AUTOTUNE_GUARD_BAND_PCT`` below the prediction triggers
   automatic rollback to threshold bucketing.

The GP side is warm-started from the same α–β model
(:func:`warm_start_manager` seeds every per-category GP with
``predict_collective_us``-derived scores) so Bayesian exploration starts
near the simulator's predicted optimum instead of at a random draw.

:func:`plan_from_trace` drives the same pipeline offline (trace dir in →
recommended plan out); on the hand-computed fixture
(timeline/replay/fixture.py ``AUTOTUNE_EXPECTED``) it recovers the
expected plan end to end.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

#: scenarios the planner may apply: only the ones whose plan payload maps
#: to concrete knobs (overlap_comm / remove_straggler / bandwidth are
#: diagnostics — there is no knob that buys them)
PLANNABLE_PREFIX = "fuse_buckets_"


@dataclasses.dataclass
class FusionPlanSpec:
    """A concrete, applicable tuning decision derived from replay.

    ``buckets`` is the vector-of-buckets knob: tensor names grouped into
    explicit fusion buckets, listed in dispatch order — bucket 0 goes on
    the wire first, which is the overlap schedule (early gradients
    transfer while later compute still runs).  ``compression`` is the
    per-bucket wire-format knob (ops/compression.py registry names
    aligned with ``buckets``; None entries ride uncompressed) — the
    simulator's staged choice search fills it, and training.py applies
    it through ``allreduce_pytree(bucket_compression=...)`` with error
    feedback, so compression decisions verify and roll back through the
    SAME guard-band machinery as fusion decisions.
    ``cycle_flush_steps`` is the flush cadence: how many optimizer
    steps a *verified* plan stays pinned before the tuner re-measures
    and re-plans from a fresh trace window (the compiled-world analog
    of the reference's cycle time; 0 pins the plan for the rest of the
    job).

    ``compute`` carries the compute-knob decisions of the compute tier
    (optim/compute_knobs.py): ``{"fused_optimizer": bool,
    "remat_policy": str, "loss_fetch_steps": int}`` entries override
    the training step's defaults in the SAME rebuild
    (training.py ``_rebuild``), so a compute decision is applied,
    verified, and rolled back through the machinery fusion decisions
    already use.  A compute-only plan has ``buckets == []`` — the
    threshold bucketing stays untouched."""

    buckets: List[List[str]]
    overlap: bool = True
    compression: Optional[List[Optional[str]]] = None
    compute: Optional[dict] = None
    cycle_flush_steps: int = 0
    predicted_step_us: float = 0.0
    baseline_step_us: float = 0.0
    predicted_speedup_pct: float = 0.0
    source_step: Optional[int] = None
    plan_id: int = 0

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FusionPlanSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def plan_from_what_if(wi: dict, *, step: Optional[int] = None,
                      baseline_us: Optional[float] = None
                      ) -> Optional[FusionPlanSpec]:
    """The best *implementable* scenario of one step's what-if report as
    a :class:`FusionPlanSpec` (None when nothing plannable beats the
    baseline)."""
    best = None
    for sc in wi.get("scenarios", ()):
        if not str(sc.get("scenario", "")).startswith(PLANNABLE_PREFIX):
            continue
        if "plan" not in sc:
            continue
        if best is None or sc["predicted_step_us"] < best["predicted_step_us"]:
            best = sc
    if best is None:
        return None
    base = baseline_us if baseline_us is not None \
        else float(wi.get("baseline_replay_us", 0.0))
    plan = best["plan"]
    comp = plan.get("compression")
    return FusionPlanSpec(
        buckets=[list(b) for b in plan["buckets"]],
        overlap=bool(plan.get("overlap", True)),
        compression=[c if c else None for c in comp]
        if comp is not None else None,
        predicted_step_us=float(best["predicted_step_us"]),
        baseline_step_us=base,
        predicted_speedup_pct=float(best.get("speedup_pct", 0.0)),
        source_step=step,
    )


def plan_from_summary(summary: dict) -> Optional[FusionPlanSpec]:
    """The best plan across every replayed step of an ``analyze()``
    summary — the step whose winning bucket plan predicts the largest
    speedup wins (plans are per-DAG-shape; SPMD steps share one shape,
    so any step's plan applies to all)."""
    best: Optional[FusionPlanSpec] = None
    for s in summary.get("steps", ()):
        p = plan_from_what_if(s.get("what_if", {}), step=s.get("step"))
        if p is None:
            continue
        if best is None or p.predicted_speedup_pct > best.predicted_speedup_pct:
            best = p
    return best


def plan_from_trace(trace_dir: str, *, cost_model=None,
                    step: Optional[int] = None) -> Optional[FusionPlanSpec]:
    """Offline entry: stitch + replay a trace dir and return the
    recommended plan."""
    from ..timeline.replay import analyze

    return plan_from_summary(
        analyze(trace_dir, step=step, cost_model=cost_model).summary)


# ---------------------------------------------------------------------------
# GP warm start from the α–β model
# ---------------------------------------------------------------------------
def predicted_score_fn(total_grad_bytes: float, world: int, *,
                       ici_bytes_per_sec: Optional[float] = None,
                       hop_latency_us: Optional[float] = None
                       ) -> Callable:
    """A ``TunableParams -> predicted bytes/sec`` scorer built on the
    shared cost model: threshold ``t`` splits the gradient volume into
    ``ceil(bytes / t)`` buckets, each paying one α, all sharing the β of
    the total payload (``predict_collective_us`` with ``calls`` = bucket
    count) — the same arithmetic the what-if simulator prices fusion
    with, so the GP's prior optimum and the simulator's agree."""
    from ..timeline.comm_report import (
        DEFAULT_ICI_BYTES_PER_SEC, DEFAULT_ICI_HOP_LATENCY,
        predict_collective_us,
    )

    bw = ici_bytes_per_sec if ici_bytes_per_sec is not None else \
        env_util.get_float(env_util.HVD_REPLAY_ICI_GBPS,
                           DEFAULT_ICI_BYTES_PER_SEC / 1e9) * 1e9
    hop = hop_latency_us if hop_latency_us is not None else \
        env_util.get_float(env_util.HVD_REPLAY_HOP_US,
                           DEFAULT_ICI_HOP_LATENCY * 1e6)
    nbytes = max(float(total_grad_bytes), 1.0)

    def score(params) -> float:
        buckets = max(int(math.ceil(
            nbytes / max(params.fusion_threshold_bytes, 1))), 1)
        t_us = predict_collective_us(
            "all-reduce", int(nbytes), max(world, 2), calls=buckets,
            ici_bytes_per_sec=bw, ici_hop_latency=hop * 1e-6)
        return nbytes / (t_us * 1e-6) if t_us > 0 else 0.0

    return score


def warm_start_manager(pm, total_grad_bytes: float,
                       world: Optional[int] = None,
                       n_points: int = 8, **model_kw) -> int:
    """Seed ``pm``'s per-category GPs with the α–β model's predicted
    scores (see :func:`predicted_score_fn`).  Returns the number of
    prior points injected."""
    if world is None:
        from .. import core

        world = core.size() if core.is_initialized() else 2
    return pm.warm_start(
        predicted_score_fn(total_grad_bytes, world, **model_kw),
        n_points=n_points)


# ---------------------------------------------------------------------------
# the in-job closed loop
# ---------------------------------------------------------------------------
class ProfileGuidedTuner:
    """The in-job loop: measure a window → plan from replay → apply →
    verify → keep or roll back.

    ``analyze_fn()`` must return an ``analyze()``-shaped summary dict (or
    None when the trace isn't ready yet — the tuner simply retries at the
    next window boundary).  ``apply_fn(plan_or_None)`` makes the plan
    live (None restores threshold bucketing); training.py routes it
    through ``ParameterManager.apply_plan`` so the rebuild seam is shared
    with classic autotuning.

    ``on_step(step_seconds)`` is the only hot-path surface: one float
    append per step, no device synchronization inside the tuner
    (training.py feeds dispatch-to-dispatch intervals and adds its own
    per-step result sync while the loop is active, so both the baseline
    and the verify window measure honest serialized step time — the
    same trade the GP path makes while tuning).

    Multi-process jobs must not let ranks decide differently (a rank
    that rolls back while another keeps its plan dispatches a different
    collective sequence → hang or sanitizer divergence).  ``window_sync``
    (window µs → process-mean) and ``plan_sync`` (plan dict or None →
    process 0's choice) make every rank see one measurement and one
    decision — the PG analog of the GP path's "synchronize the
    measurement instead of the decision" allreduce; here the plan is an
    object, so the decision itself is broadcast too.
    """

    PHASE_BASELINE = "baseline"
    PHASE_VERIFY = "verify"
    PHASE_STEADY = "steady"
    PHASE_FROZEN = "frozen"

    def __init__(self, *, analyze_fn: Callable[[], Optional[dict]],
                 apply_fn: Callable[[Optional[FusionPlanSpec]], None],
                 anatomy_fn: Optional[Callable[[], Optional[dict]]] = None,
                 fused_available: bool = True,
                 active_compute: Optional[dict] = None,
                 window_steps: Optional[int] = None,
                 guard_band_pct: Optional[float] = None,
                 rollback: Optional[bool] = None,
                 min_speedup_pct: float = 1.0,
                 max_plan_attempts: int = 8,
                 cycle_flush_steps: Optional[int] = None,
                 window_sync: Optional[Callable[[float], float]] = None,
                 plan_sync: Optional[Callable[[Optional[dict]],
                                              Optional[dict]]] = None,
                 plan_root: bool = True,
                 push_target: Optional[tuple] = None):
        self.analyze_fn = analyze_fn
        self.apply_fn = apply_fn
        self.anatomy_fn = anatomy_fn
        self.fused_available = fused_available
        #: compute knobs the job's BASE config already has on — a plan
        #: proposing one of these would be a no-op that is guaranteed
        #: to miss its prediction, get condemned, and waste two
        #: measure windows plus a rebuild (training.py fills this from
        #: the resolved fused/loss-fetch defaults)
        self.active_compute = dict(active_compute or {})
        self.window_steps = window_steps if window_steps is not None else \
            env_util.get_int(env_util.HVD_AUTOTUNE_WINDOW_STEPS,
                             env_util.DEFAULT_AUTOTUNE_WINDOW_STEPS)
        self.guard_band_pct = guard_band_pct if guard_band_pct is not None \
            else env_util.get_float(env_util.HVD_AUTOTUNE_GUARD_BAND_PCT,
                                    env_util.DEFAULT_AUTOTUNE_GUARD_BAND_PCT)
        self.rollback_enabled = rollback if rollback is not None else \
            env_util.get_bool(env_util.HVD_AUTOTUNE_ROLLBACK, True)
        self.min_speedup_pct = min_speedup_pct
        self.max_plan_attempts = max_plan_attempts
        self.cycle_flush_steps = cycle_flush_steps \
            if cycle_flush_steps is not None else env_util.get_int(
                env_util.HVD_AUTOTUNE_CYCLE_FLUSH_STEPS,
                env_util.DEFAULT_AUTOTUNE_CYCLE_FLUSH_STEPS)
        self.window_sync = window_sync
        self.plan_sync = plan_sync
        self.plan_root = plan_root
        self.push_target = push_target
        self.phase = self.PHASE_BASELINE
        self.plan: Optional[FusionPlanSpec] = None
        self.baseline_us: Optional[float] = None
        self.history: List[dict] = []
        self._window: List[float] = []
        self._plan_seq = 0
        self._plan_attempts = 0
        self._steady_left = 0
        # compute-tier bookkeeping (optim/compute_knobs.py): knobs a
        # verified plan pinned, knobs condemned by a rollback, and the
        # last verified plan a compute regression falls back to
        self._verified_compute: dict = {}
        self._condemned_compute: set = set()
        self._last_good_plan: Optional[FusionPlanSpec] = None
        # flight-recorder: the apply event roots the plan's causal
        # chain — verify/rollback chain onto it (observe/events.py)
        self._apply_event_id: Optional[str] = None

    @property
    def active(self) -> bool:
        return self.phase != self.PHASE_FROZEN

    @property
    def measuring(self) -> bool:
        """True in the phases that collect step intervals — the steady
        (plan-pinned) phase only counts steps, so callers must not pay
        measurement-honesty syncs for it."""
        return self.phase in (self.PHASE_BASELINE, self.PHASE_VERIFY)

    # -- hot path ------------------------------------------------------------
    def on_step(self, step_seconds: float) -> None:
        if not self.active or step_seconds <= 0:
            return
        if self.phase == self.PHASE_STEADY:
            # verified plan pinned for its flush cadence; when it runs
            # out, re-measure a fresh baseline (with the plan still
            # applied) and re-plan from the current trace — the adaptive
            # cycle the reference's cycle-time knob times
            self._steady_left -= 1
            if self._steady_left <= 0:
                self.phase = self.PHASE_BASELINE
                self._window = []
                self._plan_attempts = 0
            return
        self._window.append(float(step_seconds))
        if len(self._window) < self.window_steps:
            return
        window_us = float(np.median(self._window)) * 1e6
        self._window = []
        if self.window_sync is not None:
            # every process scores the same process-mean window, so the
            # phase machine below transitions identically on all ranks
            window_us = float(self.window_sync(window_us))
        if self.phase == self.PHASE_BASELINE:
            self._plan_window(window_us)
        elif self.phase == self.PHASE_VERIFY:
            self._verify_window(window_us)

    # -- plan ----------------------------------------------------------------
    def _plan_window(self, baseline_us: float) -> None:
        self.baseline_us = baseline_us
        self._plan_attempts += 1
        if self.plan_sync is not None and not self.plan_root:
            # the decision is process 0's broadcast below — stitching the
            # whole trace and running the bucket search here would be
            # thrown away, so non-root ranks only join the broadcast
            plan = None
        else:
            try:
                summary = self.analyze_fn()
            except Exception as e:  # noqa: BLE001
                log.debug("profile-guided analyze failed (%s); retrying next "
                          "window", e)
                summary = None
            plan = plan_from_summary(summary) if summary else None
            # the compute tier: knob candidates priced from the
            # profiler's per-block anatomy compete with the comm plan
            # on the same predicted-speedup scale
            cplan = self._best_compute_plan()
            if cplan is not None and (
                    plan is None
                    or cplan.predicted_speedup_pct
                    > plan.predicted_speedup_pct
                    # a comm re-plan landing on the plan already
                    # running would only be retained — spend the
                    # window on the next compute knob instead
                    or self._same_plan(plan, self.plan)):
                plan = cplan
            elif plan is not None and self._verified_compute:
                # a comm plan must re-assert the compute knobs earlier
                # windows verified: the training rebuild is whole-state,
                # so a plan without them would silently revert verified
                # optimizations (and they'd stay excluded forever)
                plan.compute = {**self._verified_compute,
                                **(plan.compute or {})}
        if self.plan_sync is not None:
            # unconditional (all ranks must join the broadcast): process
            # 0's plan-or-None wins, so a trace that flushed late on one
            # rank can't leave it bucketing differently from its peers
            d = self.plan_sync(plan.to_dict() if plan is not None else None)
            plan = FusionPlanSpec.from_dict(d) if d else None
        if plan is None:
            # trace not ready (or it carries no per-tensor comm spans —
            # e.g. a fully compiled plane) — retry next window, but not
            # forever: re-stitching a plan-less trace every window is
            # wasted work on a job that will never yield one
            if self._plan_attempts >= self.max_plan_attempts:
                self.phase = self.PHASE_FROZEN
                self._record({"outcome": "no_plan_available",
                              "windows_tried": self._plan_attempts})
                log.info("profile-guided: no applicable plan after %d "
                         "windows (no per-tensor comm spans in the "
                         "trace?) — loop frozen", self._plan_attempts)
            return
        if plan.predicted_speedup_pct < self.min_speedup_pct:
            self.phase = self.PHASE_FROZEN
            self._record({"outcome": "no_worthwhile_plan",
                          "predicted_speedup_pct":
                              plan.predicted_speedup_pct})
            log.info("profile-guided: best plan predicts only %.2f%% — "
                     "keeping threshold bucketing",
                     plan.predicted_speedup_pct)
            return
        if self._same_plan(plan, self.plan):
            # cycle-flush re-plan landed on the plan already running:
            # keep it without a rebuild.  Crucially this must NOT enter
            # verify — the new baseline was measured WITH the plan
            # applied, so the stale trace's predicted speedup would read
            # as a false regression and roll back a verified-good plan.
            self._record(dict(plan.to_dict(), plan_id=self.plan.plan_id,
                              outcome="retained"))
            if self.cycle_flush_steps > 0:
                self.phase = self.PHASE_STEADY
                self._steady_left = self.cycle_flush_steps
            else:
                self.phase = self.PHASE_FROZEN
            return
        self._plan_seq += 1
        plan.plan_id = self._plan_seq
        plan.cycle_flush_steps = self.cycle_flush_steps
        self.plan = plan
        self.apply_fn(plan)
        self._metrics_predicted(plan.predicted_speedup_pct)
        self._record(dict(plan.to_dict(), outcome="applied"))
        log.info("profile-guided: applied plan %d (%d buckets, compute "
                 "%s, predicted %+.2f%%)", plan.plan_id, plan.num_buckets,
                 plan.compute or {}, plan.predicted_speedup_pct)
        self.phase = self.PHASE_VERIFY

    @staticmethod
    def _same_plan(a: Optional[FusionPlanSpec],
                   b: Optional[FusionPlanSpec]) -> bool:
        """Same applied decision (bucketing + wire formats + compute
        knobs) — predicted numbers excluded, they drift per window."""
        return a is not None and b is not None \
            and a.buckets == b.buckets and a.overlap == b.overlap \
            and a.compression == b.compression \
            and (a.compute or None) == (b.compute or None)

    # -- the compute tier ----------------------------------------------------
    def _compute_candidates(self) -> List[FusionPlanSpec]:
        """Ranked un-tried compute-knob plans from the profiler anatomy
        ([] without an anatomy source or when every knob is applied or
        condemned)."""
        if self.anatomy_fn is None:
            return []
        try:
            anatomy = self.anatomy_fn()
        except Exception as e:  # noqa: BLE001
            log.debug("profile-guided anatomy read failed: %s", e)
            return []
        if not anatomy:
            return []
        from .compute_knobs import compute_plans_from_anatomy

        exclude = set(self._verified_compute) | self._condemned_compute \
            | set(self.active_compute)
        if self.plan is not None and self.plan.compute:
            exclude |= set(self.plan.compute)
        return compute_plans_from_anatomy(
            anatomy, exclude=exclude, fused_available=self.fused_available)

    def _best_compute_plan(self) -> Optional[FusionPlanSpec]:
        cands = self._compute_candidates()
        if not cands:
            return None
        best = cands[0]
        # accumulate the knobs earlier windows verified: the rebuild is
        # whole-state, so a new plan must re-assert them or lose them
        best.compute = {**self._verified_compute, **(best.compute or {})}
        if self.plan is not None and self.plan.buckets:
            # keep a verified comm layout while trying a compute knob
            best.buckets = [list(b) for b in self.plan.buckets]
            best.compression = list(self.plan.compression) \
                if self.plan.compression else None
        return best

    # -- verify --------------------------------------------------------------
    def _verify_window(self, realized_us: float) -> None:
        plan = self.plan
        realized_pct = (self.baseline_us - realized_us) \
            / self.baseline_us * 100.0 if self.baseline_us else 0.0
        self._metrics_realized(realized_pct)
        # The simulator predicts its speedup against the DAG replay
        # makespan; the measured window also carries host time outside
        # the DAG (input pipeline, dispatch).  Verify against the saving
        # re-based onto the measured baseline — min() with the replay
        # fraction so an overestimating replay can't demand more than
        # its own fraction either — or realistic host overhead would
        # dilute realized_pct and roll back correctly working plans.
        saved_us = plan.baseline_step_us - plan.predicted_step_us
        expected_pct = min(
            plan.predicted_speedup_pct,
            saved_us / self.baseline_us * 100.0) \
            if self.baseline_us and saved_us > 0 \
            else plan.predicted_speedup_pct
        shortfall = expected_pct - realized_pct
        rec = dict(plan.to_dict(), realized_step_us=round(realized_us, 3),
                   realized_speedup_pct=round(realized_pct, 2),
                   expected_realized_pct=round(expected_pct, 2),
                   shortfall_pct=round(shortfall, 2))
        if self.rollback_enabled and shortfall > self.guard_band_pct:
            # fall back to the LAST VERIFIED plan (None = threshold
            # bucketing) and condemn any compute knob this plan newly
            # introduced so the next window doesn't re-propose it
            fallback = self._last_good_plan
            self.apply_fn(fallback)
            self.plan = fallback
            prior = set((fallback.compute or {})) if fallback is not None \
                else set()
            self._condemned_compute |= set(plan.compute or {}) - prior
            rec["outcome"] = "rolled_back"
            self._metrics_rollback()
            log.warning(
                "profile-guided: plan %d realized %+.2f%% vs predicted "
                "%+.2f%% (guard band %.1f%%) — rolled back",
                plan.plan_id, realized_pct, plan.predicted_speedup_pct,
                self.guard_band_pct)
        else:
            rec["outcome"] = "verified"
            self._last_good_plan = plan
            if plan.compute:
                self._verified_compute.update(plan.compute)
            log.info("profile-guided: plan %d verified (realized %+.2f%% "
                     "vs predicted %+.2f%%)", plan.plan_id, realized_pct,
                     plan.predicted_speedup_pct)
        self._record(rec)
        # un-tried compute knobs remain?  The anatomy is PER-RANK data
        # (host-gap share differs across ranks), so multi-process jobs
        # take process 0's answer through the plan broadcast — every
        # rank must keep (or stop) joining the window collectives in
        # lockstep, same invariant as the plan decision itself.
        more_compute = bool(self._compute_candidates()) if self.plan_root \
            else False
        if self.plan_sync is not None:
            d = self.plan_sync({"more_compute": more_compute})
            more_compute = bool((d or {}).get("more_compute"))
        if more_compute:
            # measure a fresh baseline (with everything verified so far
            # still applied) and try the next compute knob through the
            # same apply→verify machinery
            self.phase = self.PHASE_BASELINE
            self._window = []
            self._plan_attempts = 0
        elif rec["outcome"] == "verified" and plan.cycle_flush_steps > 0:
            self.phase = self.PHASE_STEADY
            self._steady_left = plan.cycle_flush_steps
        else:
            self.phase = self.PHASE_FROZEN

    # -- bookkeeping ---------------------------------------------------------
    def _record(self, rec: dict) -> None:
        rec = dict(rec, plan_id=rec.get("plan_id", self._plan_seq))
        self.history.append(rec)
        self._record_flight_event(rec)
        if self.push_target is None:
            return
        try:
            from ..run.http_client import put_autotune_plan

            addr, port, secret = self.push_target
            put_autotune_plan(addr, port, len(self.history), rec,
                              secret=secret)
        except Exception as e:  # noqa: BLE001
            log.debug("autotune push failed: %s", e)

    def _record_flight_event(self, rec: dict) -> None:
        """Mirror apply/verify/rollback outcomes into the control-plane
        flight recorder with the predicted-vs-realized numbers; the
        verify/rollback events chain onto their plan's apply event."""
        kind = {"applied": "autotune.apply",
                "verified": "autotune.verify",
                "rolled_back": "autotune.rollback"}.get(rec.get("outcome"))
        if kind is None:
            return
        try:
            from ..observe import events as events_mod

            eid = events_mod.record_event(
                kind,
                severity="warning" if kind == "autotune.rollback"
                else "info",
                payload={
                    "plan_id": rec.get("plan_id"),
                    "predicted_speedup_pct":
                        rec.get("predicted_speedup_pct"),
                    "realized_speedup_pct":
                        rec.get("realized_speedup_pct"),
                    "shortfall_pct": rec.get("shortfall_pct"),
                    "num_buckets": len(rec.get("buckets") or []),
                    "compute": rec.get("compute"),
                },
                cause_id=None if kind == "autotune.apply"
                else self._apply_event_id)
            if kind == "autotune.apply":
                self._apply_event_id = eid
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001 — recording is best-effort
            pass

    def _metrics_predicted(self, pct: float) -> None:
        try:
            from .. import metrics

            if metrics.on():
                metrics.AUTOTUNE_PREDICTED_SPEEDUP.set(pct)
                metrics.AUTOTUNE_PLANS_APPLIED.inc()
        except Exception:  # noqa: BLE001
            pass

    def _metrics_realized(self, pct: float) -> None:
        try:
            from .. import metrics

            if metrics.on():
                metrics.AUTOTUNE_REALIZED_SPEEDUP.set(pct)
        except Exception:  # noqa: BLE001
            pass

    def _metrics_rollback(self) -> None:
        try:
            from .. import metrics

            if metrics.on():
                metrics.AUTOTUNE_ROLLBACKS.inc()
        except Exception:  # noqa: BLE001
            pass


def tuner_from_env(analyze_fn, apply_fn, anatomy_fn=None,
                   fused_available=True,
                   active_compute=None) -> ProfileGuidedTuner:
    """A tuner wired to the job's rendezvous server (push target from the
    metrics-pusher env triple) — the training.py construction path.

    Multi-process jobs get the window/plan sync hooks (process-mean
    measurement + process-0 decision broadcast) so every rank applies
    and rolls back the same plan, and only process 0 pushes the
    `/autotune` table (the scope is single-writer)."""
    addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
    port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
    secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
    push = (addr, port, bytes.fromhex(secret_hex) if secret_hex else None) \
        if addr and port else None

    window_sync = plan_sync = None
    plan_root = True
    from .. import core

    if core.is_initialized() and core.process_size() > 1:
        from .. import eager
        from ..ops.collectives import Average as _Avg

        def window_sync(us: float) -> float:
            return float(eager.process_allreduce(
                np.asarray([us], np.float64), op=_Avg,
                name="autotune.pg_window")[0])

        def plan_sync(d: Optional[dict]) -> Optional[dict]:
            return eager.broadcast_object(d, root_rank=0,
                                          name="autotune.pg_plan")

        if core.process_rank() != 0:
            push = None
            plan_root = False
    return ProfileGuidedTuner(analyze_fn=analyze_fn, apply_fn=apply_fn,
                              anatomy_fn=anatomy_fn,
                              fused_available=fused_available,
                              active_compute=active_compute,
                              window_sync=window_sync, plan_sync=plan_sync,
                              plan_root=plan_root, push_target=push)
