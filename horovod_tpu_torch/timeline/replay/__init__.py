"""dPRO-style replay engine over merged byteprofile traces: the port of
``horovod_tpu/timeline/replay/``, over the traces the port itself writes.

The capture side of this repo (per-rank ``comm.json`` timelines, the
Recorder's DAG/shape/manifest dumps, PR 1's cross-rank merge) exists so
this layer can exist: fuse every rank's artifacts into one clock-aligned
global DAG per step, find the critical path, and answer "what would
fixing X buy me?" by replaying the DAG under modified assumptions
(Hu et al., *dPRO*, MLSys 2022).

Modules:

* :mod:`~horovod_tpu_torch.timeline.replay.clock` — offset-estimation
  handshake against the rendezvous server's ``GET /clock``;
* :mod:`~horovod_tpu_torch.timeline.replay.stitcher` — global step DAG from
  merged comm events joined to ``dag.gml`` / gradient-manifest nodes;
* :mod:`~horovod_tpu_torch.timeline.replay.critical_path` — discrete-event
  schedule, clock-aligned critical path, {compute, negotiation, comm,
  idle} attribution;
* :mod:`~horovod_tpu_torch.timeline.replay.simulator` — what-if scenarios
  (bandwidth, straggler removal, overlap, fusion re-batching) priced
  with the comm_report α–β cost model;
* :mod:`~horovod_tpu_torch.timeline.replay.projection` — the fleet-scale
  digital twin: re-materialize the stitched DAG onto a hypothetical
  topology (``hvd_replay --project``) with tracked
  projected-vs-measured accuracy;
* :mod:`~horovod_tpu_torch.timeline.replay.fixture` — the hand-computed
  2-rank ground-truth trace.

``analyze(trace_dir)`` is the one-call driver; the profile-guided tuner
(``optim/profile_guided.py``) calls it on the job's own trace.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from ...utils import env as env_util
from ..comm_report import (
    DEFAULT_ICI_BYTES_PER_SEC, DEFAULT_ICI_HOP_LATENCY, per_tensor_table,
)
from .clock import estimate_offset  # noqa: F401  (public API)
from .critical_path import (  # noqa: F401
    Schedule, attribute, critical_path, describe_path, schedule,
)
from .simulator import CostModel, identify_straggler, what_if
from .stitcher import Artifacts, StepDAG, stitch  # noqa: F401

#: pid used for the synthetic "critical path" track in annotated traces
CRITICAL_PATH_PID = 9999


@dataclasses.dataclass
class ReplayResult:
    """Summary (JSON-ready) plus the internals the CLI's annotated-trace
    writer and the tests reach into."""

    summary: dict
    artifacts: Artifacts
    dags: List[StepDAG]
    schedules: Dict[int, Schedule]


def _cost_model_from_env(world: int) -> CostModel:
    return CostModel(
        world=world,
        ici_bytes_per_sec=env_util.get_float(
            env_util.HVD_REPLAY_ICI_GBPS,
            DEFAULT_ICI_BYTES_PER_SEC / 1e9) * 1e9,
        hop_latency_us=env_util.get_float(env_util.HVD_REPLAY_HOP_US,
                                          DEFAULT_ICI_HOP_LATENCY * 1e6),
        # two-level what-if shape: the job's real ICI group size unless
        # overridden (HVD_LOCAL_SIZE is launcher-set; 1 = no hierarchy,
        # scenario skipped)
        local_size=env_util.get_int(
            env_util.HVD_REPLAY_LOCAL_SIZE,
            env_util.get_int(env_util.HVD_LOCAL_SIZE, 1)),
        dcn_bytes_per_sec=env_util.get_float(
            env_util.HVD_REPLAY_DCN_GBPS,
            env_util.DEFAULT_DCN_GBPS) * 1e9,
        dcn_hop_latency_us=env_util.get_float(
            env_util.HVD_REPLAY_DCN_HOP_US, env_util.DEFAULT_DCN_HOP_US),
    )


def analyze(trace_dir: str, *, step: Optional[int] = None,
            last_steps: Optional[int] = None,
            cost_model: Optional[CostModel] = None,
            plan_search: bool = True,
            topology=None) -> ReplayResult:
    """Stitch ``trace_dir``, replay every step (or just ``step``), and
    assemble the summary: per-step critical path + attribution +
    ranked what-ifs, a per-tensor cost-model table (predicted vs
    measured, via comm_report.per_tensor_table — the SAME α–β model the
    what-ifs use), and cross-step recommendations.

    ``last_steps`` replays only the N most recent steps — the in-job
    profile-guided tuner passes 1: SPMD steps share one DAG shape, so
    the latest step's plan stands for all, and a window-cadence caller
    must not pay a whole-history replay (incl. the per-step bucket
    search) that grows with the trace."""
    art, dags = stitch(trace_dir,
                       last_steps=last_steps if step is None else None)
    if step is not None:
        dags = [d for d in dags if d.step == step]
        if not dags:
            raise ValueError(f"step {step} not present on every rank "
                             f"under {trace_dir}")
    if not dags:
        raise ValueError(
            f"no replayable step found under {trace_dir} — need matching "
            "STEP windows (or any events) on every rank"
        )
    cm = cost_model or _cost_model_from_env(len(art.ranks))
    steps_out = []
    scheds: Dict[int, Schedule] = {}
    recommendations: List[dict] = []
    for dag in dags:
        sched = schedule(dag)
        scheds[dag.step] = sched
        path = critical_path(dag, sched)
        attr = attribute(dag, sched)
        wi = what_if(dag, cm, plan_search=plan_search, topology=topology)
        measured = dag.measured_step_us
        # aggregate per tensor: a tensor collected k times in the step
        # (microbatch accumulation) contributes k calls and k measured
        # durations — collapsing to the last occurrence would price the
        # what-ifs against a fraction of the real traffic
        tensors: Dict[str, dict] = {}
        measured_comm: Dict[str, float] = {}
        for n in dag.nodes:
            if n.kind != "comm":
                continue
            key = n.tensor or n.label
            t = tensors.setdefault(key, {"op": n.op, "bytes": 0,
                                         "calls": 0})
            t["bytes"] += n.nbytes or 0
            t["calls"] += 1
            measured_comm[key] = measured_comm.get(key, 0.0) + n.dur_us
        cost_table = per_tensor_table(
            tensors, cm.world, measured_us=measured_comm,
            ici_bytes_per_sec=cm.ici_bytes_per_sec,
            ici_hop_latency=cm.hop_latency_us * 1e-6)
        steps_out.append({
            "step": dag.step,
            "ranks": sorted(dag.chains),
            "measured_step_us": round(measured, 3),
            "replay_step_us": round(sched.makespan, 3),
            "replay_error_pct": round(
                (sched.makespan - measured) / measured * 100.0, 2)
            if measured > 0 else None,
            "critical_path": describe_path(dag, sched, path),
            "attribution": attr,
            "cost_model_table": cost_table,
            "what_if": wi,
        })
        for s in wi["scenarios"]:
            recommendations.append(dict(s, step=dag.step))
    recommendations.sort(key=lambda s: -s["speedup_pct"])
    summary = {
        "trace_dir": art.trace_dir,
        "ranks": art.ranks,
        "clock_aligned": art.clock_aligned,
        "clock_offsets_us": {str(r): round(o, 3)
                             for r, o in art.clock_offsets_us.items()},
        "steps": steps_out,
        "recommendations": recommendations,
    }
    return ReplayResult(summary=summary, artifacts=art, dags=dags,
                        schedules=scheds)


def _merged_from_artifacts(art: Artifacts) -> dict:
    """merge_traces-shaped dict from already-loaded (aligned) events —
    the stitcher parsed every comm.json once; re-reading hundreds of MB
    for the annotated trace would double the run's parse cost."""
    events: List[dict] = []
    for rank in art.ranks:
        events.append({"name": "process_name", "ph": "M", "pid": rank,
                       "args": {"name": f"rank {rank}"}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": rank, "args": {"sort_index": rank}})
        for ev in art.events[rank]:
            ev = dict(ev)
            ev["pid"] = rank
            events.append(ev)
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "hvd_replay",
                          "trace_dir": art.trace_dir,
                          "clock_aligned": art.clock_aligned,
                          "clock_offsets_us": {
                              str(r): round(o, 3)
                              for r, o in art.clock_offsets_us.items()}}}


def annotated_trace(trace_dir: str, result: Optional[ReplayResult] = None,
                    out_path: Optional[str] = None) -> dict:
    """The merged Chrome trace plus a synthetic ``critical path`` track:
    one X event per critical-path node (placed at its *scheduled* time on
    the aligned clock) so chrome://tracing shows the determining chain as
    its own row group above the per-rank rows."""
    result = result or analyze(trace_dir)
    merged = _merged_from_artifacts(result.artifacts)
    events = merged["traceEvents"]
    events.append({"name": "process_name", "ph": "M",
                   "pid": CRITICAL_PATH_PID,
                   "args": {"name": "critical path (replay)"}})
    events.append({"name": "process_sort_index", "ph": "M",
                   "pid": CRITICAL_PATH_PID, "args": {"sort_index": -1}})
    for dag in result.dags:
        sched = result.schedules[dag.step]
        for i, row in enumerate(
                describe_path(dag, sched, critical_path(dag, sched))):
            who = f"rank {row['rank']}" if row["rank"] is not None \
                else ",".join(str(r) for r in row["ranks"] or ())
            name = f"CP{i}:{row['kind']}"
            if row["tensor"]:
                name += f":{row['tensor']}"
            events.append({
                "name": name, "ph": "X",
                "ts": dag.t0_us + row["start_us"], "dur": row["dur_us"],
                "pid": CRITICAL_PATH_PID, "tid": f"step {dag.step}",
                "args": {"kind": row["kind"], "who": who,
                         "label": row["label"]},
            })
    merged["otherData"]["critical_path"] = "pid %d" % CRITICAL_PATH_PID
    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged


# the digital-twin projection plane (imported last: projection builds on
# analyze/_cost_model_from_env above)
from .projection import (  # noqa: E402,F401
    base_spec_from_env, live_validation, parse_project_spec,
    project_analysis, project_dag, validate as validate_projection,
)
from ..comm_report import TopologySpec  # noqa: E402,F401  (public API)
