"""Compute-anatomy profiler: per-block device-time attribution, roofline
accounting and host-gap detection — the port of
``horovod_tpu/timeline/profiler.py``.

* :class:`ComputeProfiler` — a BYTEPS_TRACE-style step window
  (``HVD_PROFILE_START_STEP`` / ``END_STEP``, defaulting to the
  timeline's ``HVD_TRACE_*`` knobs) during which ``make_train_step`` runs
  its step *decomposed*: forward / backward / grad_allreduce /
  optimizer_update run one by one, eagerly (outside any CUDA graph),
  with a device sync closing each, so every block's device time is
  host-visible.  Each block carries its FLOPs, as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them over the
  block's first run (the reference takes XLA's ``cost_analysis()``;
  the port's kernels K1-K4 are ``torch.library`` ops with FLOP
  formulas, so they are counted), and its bytes, those of its inputs
  and outputs.  ``HVD_PROFILE_XLA=1`` also captures a torch.profiler
  (CUPTI) trace of the window into ``<rank>/cuda_trace/`` — the
  reference's ``jax.profiler`` capture;
* :func:`reduce_trace_events` — the parser: a pure function reducing
  Chrome-trace-style events (X spans or B/E pairs, ``STEP`` envelopes)
  into the per-rank anatomy — per-segment device µs / occurrence count /
  flops / bytes, roofline verdict per block (:func:`roofline_verdict`),
  and device-idle-waiting-on-host ("host gap") detection from the gaps
  inside each step envelope;
* ``compute.json`` — the per-rank artifact written next to ``comm.json``
  at window end (and at timeline shutdown as a backstop):
  ``{"rank", "clock", "anatomy", "events"}``, the reference's schema;
* :func:`aggregate_anatomies` — the cross-rank reduction: per-segment
  slowest rank, mean/max host gap, mean MFU.

Finalizing a window pushes the anatomy to the launcher's ``profile``
scope when ``HVD_METRICS_KV_*`` names the rendezvous server
(``GET /profile``).  The dormant profiler the reference's watchdog arms
comes with the watchdog (ROADMAP item 15); :func:`from_env` returning
None means no profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

#: ``cat`` tag on segment events (distinguishes them from STEP envelopes)
SEGMENT_CAT = "compute_segment"
STEP_NAME = "STEP"

#: the per-rank artifact name, next to comm.json
COMPUTE_JSON = "compute.json"

#: merged-trace row group base: compute rows render under pid
#: COMPUTE_PID_BASE + rank so viewers show them as their own process
#: group per rank (timeline/merge.py)
COMPUTE_PID_BASE = 100000


# ---------------------------------------------------------------------------
# roofline accounting
# ---------------------------------------------------------------------------
def roofline_verdict(flops: Optional[float], nbytes: Optional[float],
                     device_us: float, *, peak_flops: float,
                     hbm_bytes_per_sec: float) -> Dict[str, Any]:
    """Price one segment against the roofline.

    The ridge point is ``peak_flops / hbm_bytes_per_sec`` flops/byte: a
    segment whose arithmetic intensity sits at or above it is limited by
    the tensor cores (``compute-bound``), below it by HBM
    (``memory-bound``);
    with neither flops nor bytes known the verdict is ``unknown`` (the
    segment still counts device time).  Alongside the verdict: achieved
    FLOP/s and its peak fraction (the segment's MFU), achieved bytes/s
    and its bandwidth fraction — the "how far from the roof" numbers the
    next perf PR needs as targets."""
    out: Dict[str, Any] = {"verdict": "unknown"}
    if device_us <= 0.0:
        return out
    secs = device_us * 1e-6
    if flops is not None:
        out["achieved_flops_per_sec"] = flops / secs
        out["mfu"] = flops / secs / peak_flops
    if nbytes is not None:
        out["achieved_bytes_per_sec"] = nbytes / secs
        out["hbm_fraction"] = nbytes / secs / hbm_bytes_per_sec
    ridge = peak_flops / hbm_bytes_per_sec
    if flops is not None and nbytes is not None:
        if nbytes > 0:
            out["intensity_flops_per_byte"] = flops / nbytes
            out["verdict"] = ("compute-bound"
                              if flops / nbytes >= ridge else "memory-bound")
        elif flops > 0:
            out["verdict"] = "compute-bound"
    elif flops is not None and flops > 0:
        out["verdict"] = "compute-bound"
    elif nbytes is not None and nbytes > 0:
        out["verdict"] = "memory-bound"
    return out


# ---------------------------------------------------------------------------
# the parser: trace events -> anatomy
# ---------------------------------------------------------------------------
def _empty_anatomy(peak_flops: float, hbm_bytes_per_sec: float,
                   gap_threshold_us: float) -> Dict[str, Any]:
    return {
        "steps": 0,
        "wall_us": 0.0,
        "segments": {},
        "host_gap": {"total_us": 0.0, "per_step_us": 0.0, "fraction": 0.0,
                     "spans": [], "flagged": 0},
        "mfu": None,
        "top_segment": None,
        "verdict": "empty",
        "unmatched_spans": 0,
        "peak_flops": peak_flops,
        "hbm_bytes_per_sec": hbm_bytes_per_sec,
        "gap_threshold_us": gap_threshold_us,
    }


def _collect_spans(events: List[dict]):
    """``(steps, segments, unmatched)`` from a trace-event list.

    ``steps``: (start, end) of every STEP X envelope; ``segments``:
    (name, start, end, flops, bytes) for every non-STEP X span plus
    every matched B/E pair (keyed by (name, tid) like the comm
    timeline); ``unmatched``: repeated-B overwrites, stray Es, and
    spans still open at end-of-trace — a truncated capture shows up
    here instead of silently under-counting."""
    steps: List[tuple] = []
    segs: List[tuple] = []
    open_spans: Dict[tuple, tuple] = {}
    unmatched = 0
    for ev in events:
        name = str(ev.get("name", ""))
        ph = ev.get("ph", "X")
        ts = float(ev.get("ts", 0.0))
        args = ev.get("args") or {}
        flops = args.get("flops")
        nbytes = args.get("bytes")
        if name == STEP_NAME:
            if ph == "X":
                steps.append((ts, ts + float(ev.get("dur", 0.0))))
            continue
        if not name:
            continue
        if ph == "X":
            segs.append((name, ts, ts + float(ev.get("dur", 0.0)),
                         flops, nbytes))
        elif ph == "B":
            key = (name, str(ev.get("tid", "")))
            if key in open_spans:
                unmatched += 1          # earlier B never saw its E
            open_spans[key] = (ts, flops, nbytes)
        elif ph == "E":
            key = (name, str(ev.get("tid", "")))
            if key not in open_spans:
                unmatched += 1          # E without a B
                continue
            t0, f0, b0 = open_spans.pop(key)
            segs.append((name, t0, ts, flops if flops is not None else f0,
                         nbytes if nbytes is not None else b0))
    unmatched += len(open_spans)        # dangling Bs
    segs.sort(key=lambda s: s[1])
    steps.sort()
    return steps, segs, unmatched


def reduce_trace_events(
    events: List[dict],
    *,
    peak_flops: Optional[float] = None,
    hbm_bytes_per_sec: Optional[float] = None,
    gap_threshold_us: Optional[float] = None,
    host_bound_fraction: float = env_util.DEFAULT_PROFILE_HOST_BOUND_FRACTION,
) -> Dict[str, Any]:
    """Reduce a captured trace-event stream into the step anatomy.

    Segment totals are summed per name; flops/bytes accumulate only when
    present (an unknown segment name with no cost data still counts its
    device time, verdict ``unknown``).  Host gap = each STEP envelope's
    duration minus the union of segment spans inside it, with individual
    inter-dispatch gaps >= ``gap_threshold_us`` recorded as flagged
    spans.  Without STEP envelopes the segments' own envelope stands in
    as one step; with nothing at all the anatomy is ``verdict: empty``.
    """
    from ..utils import flops as flops_util

    peak = peak_flops if peak_flops is not None else flops_util.peak_flops()
    hbm = hbm_bytes_per_sec if hbm_bytes_per_sec is not None \
        else flops_util.hbm_bytes_per_sec()
    gap_thresh = gap_threshold_us if gap_threshold_us is not None \
        else env_util.get_float(env_util.HVD_PROFILE_GAP_THRESHOLD_US,
                                env_util.DEFAULT_PROFILE_GAP_THRESHOLD_US)

    steps, segs, unmatched = _collect_spans(events)
    if not steps and not segs:
        out = _empty_anatomy(peak, hbm, gap_thresh)
        out["unmatched_spans"] = unmatched
        return out
    if not steps:
        steps = [(min(s[1] for s in segs), max(s[2] for s in segs))]

    # per-name totals
    totals: Dict[str, Dict[str, Any]] = {}
    for name, t0, t1, flops, nbytes in segs:
        d = totals.setdefault(name, {"device_us": 0.0, "count": 0,
                                     "flops": None, "bytes": None})
        d["device_us"] += t1 - t0
        d["count"] += 1
        if flops is not None:
            d["flops"] = (d["flops"] or 0.0) + float(flops)
        if nbytes is not None:
            d["bytes"] = (d["bytes"] or 0.0) + float(nbytes)

    # host gap: per step envelope, uncovered time between dispatches
    wall_us = sum(t1 - t0 for t0, t1 in steps)
    gap_total = 0.0
    flagged: List[dict] = []
    for i, (s0, s1) in enumerate(steps):
        cursor = s0
        inside = [s for s in segs if s[2] > s0 + 1e-9 and s[1] < s1 - 1e-9]
        for _name, t0, t1, _f, _b in inside:
            t0, t1 = max(t0, s0), min(t1, s1)
            if t0 > cursor + 1e-9:
                gap = t0 - cursor
                gap_total += gap
                if gap >= gap_thresh:
                    flagged.append({"step": i, "start_us": round(cursor, 3),
                                    "dur_us": round(gap, 3)})
            cursor = max(cursor, t1)
        if s1 > cursor + 1e-9:
            gap = s1 - cursor
            gap_total += gap
            if gap >= gap_thresh:
                flagged.append({"step": i, "start_us": round(cursor, 3),
                                "dur_us": round(gap, 3)})

    n_steps = len(steps)
    segments: Dict[str, Dict[str, Any]] = {}
    flops_known = 0.0
    any_flops = False
    for name, d in sorted(totals.items(), key=lambda kv: -kv[1]["device_us"]):
        entry: Dict[str, Any] = {
            "device_us": round(d["device_us"], 3),
            "count": d["count"],
            "per_step_us": round(d["device_us"] / n_steps, 3),
            "flops": d["flops"],
            "bytes": d["bytes"],
            "fraction": round(d["device_us"] / wall_us, 4)
            if wall_us > 0 else 0.0,
        }
        entry.update(roofline_verdict(
            d["flops"], d["bytes"], d["device_us"],
            peak_flops=peak, hbm_bytes_per_sec=hbm))
        segments[name] = entry
        if d["flops"] is not None:
            flops_known += d["flops"]
            any_flops = True

    gap_fraction = gap_total / wall_us if wall_us > 0 else 0.0
    top = max(totals, key=lambda n: totals[n]["device_us"]) if totals \
        else None
    verdict = "host-bound" if gap_fraction >= host_bound_fraction else (
        segments[top]["verdict"] if top else "empty")
    mfu = flops_known / (wall_us * 1e-6 * peak) \
        if any_flops and wall_us > 0 else None
    return {
        "steps": n_steps,
        "wall_us": round(wall_us, 3),
        "segments": segments,
        "host_gap": {
            "total_us": round(gap_total, 3),
            "per_step_us": round(gap_total / n_steps, 3),
            "fraction": round(gap_fraction, 4),
            "spans": flagged,
            "flagged": len(flagged),
        },
        "mfu": round(mfu, 4) if mfu is not None else None,
        "top_segment": top,
        "verdict": verdict,
        "unmatched_spans": unmatched,
        "peak_flops": peak,
        "hbm_bytes_per_sec": hbm,
        "gap_threshold_us": gap_thresh,
    }


# ---------------------------------------------------------------------------
# cross-rank aggregation (the reference's GET /profile and hvd_profile)
# ---------------------------------------------------------------------------
def aggregate_anatomies(per_rank: Dict[str, dict]) -> Dict[str, Any]:
    """Cross-rank anatomy reduction — ONE implementation shared by the
    rendezvous server's ``GET /profile`` and the CLI, so the live route
    and the offline report can never disagree on who the slowest rank
    is.  Per segment: each rank's device µs, the slowest rank, and the
    max−min spread; plus mean MFU and the worst host gap."""
    segs: Dict[str, Dict[str, float]] = {}
    mfus: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    verdicts: Dict[str, str] = {}
    for rank, an in sorted(per_rank.items()):
        if not isinstance(an, dict):
            continue
        for name, d in (an.get("segments") or {}).items():
            segs.setdefault(name, {})[rank] = float(d.get("device_us", 0.0))
            verdicts.setdefault(name, d.get("verdict", "unknown"))
        if an.get("mfu") is not None:
            mfus[rank] = float(an["mfu"])
        hg = an.get("host_gap") or {}
        gaps[rank] = float(hg.get("per_step_us", 0.0))
    out_segs: Dict[str, dict] = {}
    for name, by_rank in segs.items():
        slowest = max(by_rank, key=by_rank.get)
        out_segs[name] = {
            "per_rank_device_us": {r: round(v, 3)
                                   for r, v in sorted(by_rank.items())},
            "mean_device_us": round(sum(by_rank.values()) / len(by_rank), 3),
            "slowest_rank": slowest,
            "spread_us": round(max(by_rank.values())
                               - min(by_rank.values()), 3),
            "verdict": verdicts.get(name, "unknown"),
        }
    top = sorted(out_segs, key=lambda n: -out_segs[n]["mean_device_us"])
    return {
        "ranks": sorted(per_rank),
        "segments": out_segs,
        "top_segments": top,
        "mfu": {
            "per_rank": {r: round(v, 4) for r, v in sorted(mfus.items())},
            "mean": round(sum(mfus.values()) / len(mfus), 4)
            if mfus else None,
        },
        "host_gap_per_step_us": {
            "per_rank": {r: round(v, 3) for r, v in sorted(gaps.items())},
            "max_rank": max(gaps, key=gaps.get) if gaps else None,
        },
    }


def load_compute_json(trace_dir: str) -> Dict[int, dict]:
    """rank -> parsed compute.json for every per-rank subdir that has
    one (same directory convention as merge.discover_ranks; a dir
    without any is simply empty — the caller decides whether that is an
    error)."""
    out: Dict[int, dict] = {}
    for entry in sorted(os.listdir(trace_dir)):
        if not entry.isdigit():
            continue
        p = os.path.join(trace_dir, entry, COMPUTE_JSON)
        if not os.path.isfile(p):
            continue
        try:
            with open(p) as f:
                out[int(entry)] = json.load(f)
        except (ValueError, OSError):
            log.warning("profiler: undecodable %s", p)
    return dict(sorted(out.items()))


def own_rank_anatomy(trace_dir: str,
                     rank: Optional[int] = None) -> Optional[dict]:
    """THIS rank's anatomy from an already-written ``compute.json``
    (None when absent/undecodable) — the compute-knob tuner's offline
    plan source (optim/compute_knobs.py): a job restarted over the same
    trace dir can plan compute knobs from its previous incarnation's
    window before its own profiler has run."""
    if rank is None:
        from .. import core

        rank = core.process_rank() if core.is_initialized() else 0
    p = os.path.join(trace_dir, str(rank), COMPUTE_JSON)
    if not os.path.isfile(p):
        return None
    try:
        with open(p) as f:
            return json.load(f).get("anatomy") or None
    except (ValueError, OSError):
        return None


def report_from_dir(trace_dir: str) -> Dict[str, Any]:
    """The step-anatomy report for a whole trace dir: every rank's
    anatomy plus the cross-rank aggregate — the payload of the
    reference's ``hvd_profile`` and ``GET /profile``."""
    per_rank = load_compute_json(trace_dir)
    if not per_rank:
        raise FileNotFoundError(
            f"no <rank>/{COMPUTE_JSON} under {trace_dir} — run with "
            "HVD_PROFILE=1 and a timeline dir first")
    anatomies = {str(r): d.get("anatomy", {}) for r, d in per_rank.items()}
    return {
        "trace_dir": os.path.abspath(trace_dir),
        "ranks": anatomies,
        "aggregate": aggregate_anatomies(anatomies),
    }


# ---------------------------------------------------------------------------
# the live profiler
# ---------------------------------------------------------------------------

#: the torch.profiler capture's directory under ``<rank>/`` (the
#: reference's ``xla_trace``)
CUDA_TRACE_DIR = "cuda_trace"
#: seconds the card idles after the capture starts and before it stops
CUDA_TRACE_MARGIN_S = 0.05


def _sync(out) -> None:
    """Wait for the device work behind ``out`` (a tensor or a nest of
    them) to finish; nothing to wait for on the CPU."""
    import torch

    from ..utils.tree import tree_flatten

    stack = [out]
    while stack:
        o = stack.pop()
        if torch.is_tensor(o):
            if o.device.type == "cuda":
                torch.cuda.synchronize(o.device)
                return
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(tree_flatten(o)[0])
        elif hasattr(o, "_asdict"):
            stack.extend(o._asdict().values())


def _start_cuda_trace():
    """A started torch.profiler over the CPU and, with a card, CUDA
    activities (None when it cannot start).  With a card it idles
    :data:`CUDA_TRACE_MARGIN_S` once started: the profiler drops device
    records stamped before its window opens, so work launched at once
    could lose its first kernels."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            time.sleep(CUDA_TRACE_MARGIN_S)
        return prof
    except Exception as e:  # noqa: BLE001
        log.debug("torch.profiler capture unavailable: %s", e)
        return None


def _stop_cuda_trace(prof, directory: str) -> None:
    """Stop ``prof`` and write its Chrome trace as
    ``<directory>/trace.json``."""
    try:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
            time.sleep(CUDA_TRACE_MARGIN_S)
        prof.__exit__(None, None, None)
        os.makedirs(directory, exist_ok=True)
        prof.export_chrome_trace(os.path.join(directory, "trace.json"))
    except Exception as e:  # noqa: BLE001
        log.warning("torch.profiler capture failed: %s", e)

#: profilers that started a capture and have not finalized — the
#: timeline-shutdown backstop flushes these (Timeline.shutdown)
_ACTIVE: List["ComputeProfiler"] = []


def finalize_active() -> None:
    """Flush every still-open profiler (called by Timeline.shutdown so
    compute.json lands next to comm.json even when the job never ran
    past the window's end step)."""
    for prof in list(_ACTIVE):
        prof.finalize()


class ComputeProfiler:
    """Step-windowed compute profiler (one per ``make_train_step``).

    ``on_step()`` advances the window; while it returns True the step
    wrapper runs the decomposed per-segment path, timing each block via
    :meth:`run_segment` (dispatch + device, closed by a device sync)
    inside a :meth:`step_span` envelope.  Past the end step
    :meth:`finalize` reduces the events, writes ``compute.json`` and
    exports the ``hvd_mfu`` / ``hvd_step_phase_fraction`` /
    ``hvd_host_gap_us`` gauges."""

    def __init__(self, trace_dir: Optional[str] = None,
                 rank: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 start_step: Optional[int] = None,
                 end_step: Optional[int] = None):
        trace_dir = trace_dir or env_util.get_str(env_util.HVD_TIMELINE) \
            or env_util.get_str(env_util.HVD_TRACE_DIR)
        if enabled is None:
            enabled = env_util.get_bool(env_util.HVD_PROFILE)
        if enabled and not trace_dir:
            log.warning("HVD_PROFILE=1 without HVD_TIMELINE/HVD_TRACE_DIR: "
                        "nowhere to write compute.json — profiler disabled")
            enabled = False
        self.enabled = bool(enabled)
        if rank is None:
            from .. import core

            rank = core.process_rank() if core.is_initialized() else 0
        self.rank = rank
        self.dir = os.path.join(trace_dir, str(rank)) if trace_dir else None
        if start_step is None:
            start_step = env_util.get_int(
                env_util.HVD_PROFILE_START_STEP,
                max(env_util.get_int(env_util.HVD_TRACE_START_STEP, 1), 1))
        self.start_step = max(int(start_step), 1)
        if end_step is None:
            end_step = env_util.get_int(
                env_util.HVD_PROFILE_END_STEP,
                env_util.get_int(
                    env_util.HVD_TRACE_END_STEP,
                    self.start_step + env_util.DEFAULT_PROFILE_STEPS - 1))
        self.end_step = int(end_step)
        from ..utils import flops as flops_util

        self.peak_flops = flops_util.peak_flops()
        self.hbm_bytes_per_sec = flops_util.hbm_bytes_per_sec()
        self.gap_threshold_us = env_util.get_float(
            env_util.HVD_PROFILE_GAP_THRESHOLD_US,
            env_util.DEFAULT_PROFILE_GAP_THRESHOLD_US)
        self._xla = env_util.get_bool(env_util.HVD_PROFILE_XLA)
        self._cuda_trace = None         # the torch.profiler of the window
        self._step = 0
        self._events: List[dict] = []
        self._origin = time.perf_counter()
        self._started = False
        self._finalized = False
        self._in_step = False
        self._finalize_pending = False
        self._clock = None              # latched at capture start
        self.anatomy: Optional[dict] = None

    # -- clock --------------------------------------------------------------
    def _now(self) -> float:
        """µs on the timeline's trace clock when it was recording at
        capture start (so compute.json events land on the same clock as
        comm.json and the per-rank ``clock_sync.json`` offset applies
        to both); the profiler's own origin otherwise.  The source is
        LATCHED at capture start — a timeline auto-closing mid-window
        must not jump the origin between two recorded spans (the
        timeline's ``_ts_us`` keeps ticking after its writer closes)."""
        if self._clock is not None:
            return self._clock()
        return (time.perf_counter() - self._origin) * 1e6

    @property
    def clock_name(self) -> str:
        return "timeline" if self._clock is not None else "local"

    # -- window -------------------------------------------------------------
    @property
    def capturing(self) -> bool:
        return (self.enabled and not self._finalized
                and self.start_step <= self._step <= self.end_step)

    def on_step(self) -> bool:
        """Advance the window; True while this step should run the
        profiled (decomposed) path.  Auto-finalizes past the end step."""
        if not self.enabled or self._finalized:
            return False
        self._step += 1
        if self._step > self.end_step:
            self.finalize()
            return False
        if self._step < self.start_step:
            return False
        if not self._started:
            self._started = True
            _ACTIVE.append(self)
            from .timeline import timeline

            if timeline.active:
                self._clock = timeline._ts_us
            if self._xla and self.dir:
                self._cuda_trace = _start_cuda_trace()
        return True

    def arm(self, start_step: int, end_step: int, *,
            current_step: Optional[int] = None,
            trace_dir: Optional[str] = None) -> None:
        """(Re)open the capture window — the watchdog's auto-arm seam
        (observe/autoarm.py).

        ``start_step``/``end_step`` are *global* training-step numbers
        when ``current_step`` (the rank's cadence step) is given: the
        counter is synced to it so a dormant profiler — constructed
        disabled, never advanced — lands the window on the same steps
        as every other rank.  A finalized profiler is reset for a
        fresh capture; its next finalize overwrites compute.json and
        re-pushes the anatomy.  The fields are plain ints/bools, so the
        worst cross-thread interleaving with ``on_step`` is a one-step
        window shift."""
        if current_step is not None:
            self._step = int(current_step)
        if trace_dir and self.dir is None:
            self.dir = os.path.join(trace_dir, str(self.rank))
        self.start_step = max(int(start_step), self._step + 1)
        self.end_step = int(end_step)
        self._finalized = False
        self._finalize_pending = False
        self._started = False
        self._events = []
        self._clock = None
        self._cuda_trace = None
        self.anatomy = None
        self.enabled = True
        log.info("compute profiler armed: steps [%d, %d]",
                 self.start_step, self.end_step)

    # -- recording ----------------------------------------------------------
    @contextlib.contextmanager
    def step_span(self):
        """One STEP envelope in the captured stream — the unit the
        parser computes host gaps inside.  A finalize that lands while
        the step is in flight (e.g. the timeline window auto-closing
        under this very step's ``record_step``) is deferred to the
        span's close so the step's segments make it into the artifact."""
        self._in_step = True
        t0 = self._now()
        try:
            yield
        finally:
            self._events.append({
                "name": STEP_NAME, "cat": f"step_{self._step}", "ph": "X",
                "ts": t0, "dur": self._now() - t0,
                "pid": self.rank, "tid": "step",
            })
            self._in_step = False
            if self._finalize_pending:
                self._finalize_pending = False
                self.finalize()

    def run_segment(self, name: str, fn, *args,
                    flops: Optional[float] = None,
                    nbytes: Optional[float] = None):
        """Run one step block and record its span.  The trailing device
        sync closes the span at device completion — that sync is the
        decomposed path's honesty (and its documented perturbation: only
        window steps pay it)."""
        t0 = self._now()
        out = fn(*args)
        _sync(out)
        ev = {
            "name": name, "cat": SEGMENT_CAT, "ph": "X",
            "ts": t0, "dur": self._now() - t0,
            "pid": self.rank, "tid": "compute",
            "args": {"step": self._step},
        }
        if flops is not None:
            ev["args"]["flops"] = float(flops)
        if nbytes is not None:
            ev["args"]["bytes"] = float(nbytes)
        self._events.append(ev)
        return out

    # -- finalization -------------------------------------------------------
    def finalize(self) -> Optional[dict]:
        """Reduce, persist, export, push — idempotent; deferred to the
        span close when a profiled step is mid-flight."""
        if not self.enabled or self._finalized:
            return self.anatomy
        if self._in_step:
            self._finalize_pending = True
            return self.anatomy
        self._finalized = True
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        if self._cuda_trace is not None:
            _stop_cuda_trace(self._cuda_trace,
                             os.path.join(self.dir, CUDA_TRACE_DIR))
            self._cuda_trace = None
        if not self._started:
            return None                  # never captured: no artifact
        self.anatomy = reduce_trace_events(
            self._events,
            peak_flops=self.peak_flops,
            hbm_bytes_per_sec=self.hbm_bytes_per_sec,
            gap_threshold_us=self.gap_threshold_us)
        if self.dir:
            try:
                os.makedirs(self.dir, exist_ok=True)
                with open(os.path.join(self.dir, COMPUTE_JSON), "w") as f:
                    json.dump({
                        "rank": self.rank,
                        "clock": self.clock_name,
                        "anatomy": self.anatomy,
                        "events": self._events,
                    }, f, indent=1)
            except OSError as e:
                log.warning("compute.json write failed: %s", e)
        self._export_gauges()
        self._push_summary()
        log.info("compute profiler: %d step(s) captured, top segment %s "
                 "(%s), mfu %s",
                 self.anatomy["steps"], self.anatomy["top_segment"],
                 self.anatomy["verdict"], self.anatomy["mfu"])
        return self.anatomy

    def _export_gauges(self) -> None:
        try:
            from .. import metrics

            if not metrics.on() or self.anatomy is None:
                return
            from ..metrics import timeseries

            if self.anatomy["mfu"] is not None:
                metrics.MFU.set(self.anatomy["mfu"])
                if timeseries.on():
                    timeseries.record(timeseries.MFU_SERIES,
                                      self.anatomy["mfu"],
                                      step=self._step)
            metrics.HOST_GAP_US.set(
                self.anatomy["host_gap"]["per_step_us"])
            if timeseries.on():
                timeseries.record(timeseries.HOST_GAP_US_SERIES,
                                  self.anatomy["host_gap"]["per_step_us"],
                                  step=self._step)
            for name, d in self.anatomy["segments"].items():
                metrics.STEP_PHASE_FRACTION.labels(name).set(d["fraction"])
            metrics.STEP_PHASE_FRACTION.labels("host_gap").set(
                self.anatomy["host_gap"]["fraction"])
        except Exception as e:  # noqa: BLE001 — metrics must not fail a run
            log.debug("profiler gauge export failed: %s", e)

    def _push_summary(self) -> None:
        """Publish the anatomy under the rendezvous ``profile`` scope
        (key = rank) so the launcher's signed ``GET /profile`` serves
        the cross-rank aggregate.  Same env wiring as the metrics
        pusher; never fatal."""
        addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
        port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
        if not addr or not port or self.anatomy is None:
            return
        secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
        secret = bytes.fromhex(secret_hex) if secret_hex else None
        try:
            from ..run.http_client import put_profile_summary

            put_profile_summary(addr, port, self.rank, self.anatomy,
                                secret=secret)
        except Exception as e:  # noqa: BLE001
            log.debug("profile push skipped: %s", e)


def from_env(rank: Optional[int] = None) -> Optional[ComputeProfiler]:
    """The training-layer entry: an enabled profiler, or None when
    HVD_PROFILE is off (so the step wrapper pays nothing)."""
    prof = ComputeProfiler(rank=rank)
    return prof if prof.enabled else None


# ---------------------------------------------------------------------------
# fixture: hand-computed ground truth (the reference's hvd_profile --check)
# ---------------------------------------------------------------------------
#: fixture roofline constants — ridge = 200e12 / 800e9 = 250 flops/byte
PROFILE_PEAK_FLOPS = 200e12
PROFILE_HBM_BYTES_PER_SEC = 800e9
PROFILE_GAP_THRESHOLD_US = 25.0

#: Two ranks, two 1000 µs steps each.  Rank 0 per step:
#:
#: ::
#:
#:     [forward 0-250][gap 50][backward 300-800][allreduce 800-900]
#:     [optimizer 900-950][gap 50]
#:
#: forward 250 µs @ 10 GF / 20 MB → intensity 500 ≥ ridge →
#: compute-bound, achieved 40 TF/s = 20% of peak; backward 500 µs @
#: 20 GF / 50 MB → intensity 400 → compute-bound; grad_allreduce 100 µs
#: @ 0 F / 50 MB → memory-bound; optimizer_update 50 µs @ 0 F / 30 MB →
#: memory-bound.  Host gap 100 µs/step (2 flagged 50 µs spans), step
#: MFU = 30 GF / (1 ms × 200 TF/s) = 0.15.  Rank 1 is identical except
#: backward runs 550 µs back-to-back with forward (one 50 µs tail gap)
#: — the per-segment slowest rank the aggregate must name.
PROFILE_EXPECTED: Dict[str, Any] = {
    "peak_flops": PROFILE_PEAK_FLOPS,
    "hbm_bytes_per_sec": PROFILE_HBM_BYTES_PER_SEC,
    "gap_threshold_us": PROFILE_GAP_THRESHOLD_US,
    "ranks": {
        "0": {
            "steps": 2, "wall_us": 2000.0, "mfu": 0.15,
            "host_gap_total_us": 200.0, "host_gap_per_step_us": 100.0,
            "host_gap_fraction": 0.1, "flagged_gaps": 4,
            "top_segment": "backward", "verdict": "compute-bound",
            "segments": {
                "forward": {"device_us": 500.0, "count": 2,
                            "fraction": 0.25, "intensity": 500.0,
                            "mfu": 0.2, "verdict": "compute-bound"},
                "backward": {"device_us": 1000.0, "count": 2,
                             "fraction": 0.5, "intensity": 400.0,
                             "mfu": 0.2, "verdict": "compute-bound"},
                "grad_allreduce": {"device_us": 200.0, "count": 2,
                                   "fraction": 0.1,
                                   "verdict": "memory-bound"},
                "optimizer_update": {"device_us": 100.0, "count": 2,
                                     "fraction": 0.05,
                                     "verdict": "memory-bound"},
            },
        },
        "1": {
            "steps": 2, "wall_us": 2000.0, "mfu": 0.15,
            "host_gap_total_us": 100.0, "host_gap_per_step_us": 50.0,
            "host_gap_fraction": 0.05, "flagged_gaps": 2,
            "top_segment": "backward", "verdict": "compute-bound",
            "segments": {
                "forward": {"device_us": 500.0, "count": 2,
                            "fraction": 0.25, "intensity": 500.0,
                            "mfu": 0.2, "verdict": "compute-bound"},
                "backward": {"device_us": 1100.0, "count": 2,
                             "fraction": 0.55, "intensity": 400.0,
                             "verdict": "compute-bound"},
                "grad_allreduce": {"device_us": 200.0, "count": 2,
                                   "fraction": 0.1,
                                   "verdict": "memory-bound"},
                "optimizer_update": {"device_us": 100.0, "count": 2,
                                     "fraction": 0.05,
                                     "verdict": "memory-bound"},
            },
        },
    },
    "slowest": {"backward": "1"},
    "backward_spread_us": 100.0,
    "aggregate_mfu": 0.15,
    "host_gap_max_rank": "0",
}

_FIXTURE_SEGMENTS = {
    # name: (flops, bytes) per occurrence
    "forward": (10e9, 20e6),
    "backward": (20e9, 50e6),
    "grad_allreduce": (0.0, 50e6),
    "optimizer_update": (0.0, 30e6),
}


def profile_fixture_events(rank: int) -> List[dict]:
    """The fixture's raw trace-event stream for one rank (pure python —
    this is the corpus the parser is pinned against on CPU tier-1)."""
    layout = {
        0: (("forward", 0.0, 250.0), ("backward", 300.0, 500.0),
            ("grad_allreduce", 800.0, 100.0),
            ("optimizer_update", 900.0, 50.0)),
        1: (("forward", 0.0, 250.0), ("backward", 250.0, 550.0),
            ("grad_allreduce", 800.0, 100.0),
            ("optimizer_update", 900.0, 50.0)),
    }[rank]
    events: List[dict] = []
    for step in (1, 2):
        o = (step - 1) * 1000.0
        events.append({"name": STEP_NAME, "cat": f"step_{step}", "ph": "X",
                       "ts": o, "dur": 1000.0, "pid": rank, "tid": "step"})
        for name, ts, dur in layout:
            flops, nbytes = _FIXTURE_SEGMENTS[name]
            events.append({
                "name": name, "cat": SEGMENT_CAT, "ph": "X",
                "ts": o + ts, "dur": dur, "pid": rank, "tid": "compute",
                "args": {"step": step, "flops": flops, "bytes": nbytes},
            })
    return events


def write_profile_fixture(trace_dir: str) -> Dict[str, Any]:
    """Materialize the fixture as per-rank ``compute.json`` artifacts
    (events + parser-reduced anatomy) and return
    :data:`PROFILE_EXPECTED` — the corpus ``hvd_profile --check`` and
    the tier-1 tests recover exactly."""
    for rank in (0, 1):
        d = os.path.join(trace_dir, str(rank))
        os.makedirs(d, exist_ok=True)
        events = profile_fixture_events(rank)
        anatomy = reduce_trace_events(
            events, peak_flops=PROFILE_PEAK_FLOPS,
            hbm_bytes_per_sec=PROFILE_HBM_BYTES_PER_SEC,
            gap_threshold_us=PROFILE_GAP_THRESHOLD_US)
        with open(os.path.join(d, COMPUTE_JSON), "w") as f:
            json.dump({"rank": rank, "clock": "fixture",
                       "anatomy": anatomy, "events": events}, f, indent=1)
    return dict(PROFILE_EXPECTED)
