"""Discrete-event scheduling + critical path over a stitched StepDAG:
the port of ``horovod_tpu/timeline/replay/critical_path.py``.

The replay core: given the stitcher's global DAG, compute when every
node runs under the chosen assumptions, which chain of nodes actually
determined the step time (the clock-aligned critical path), and where
each rank's share of the step went — ``{compute, comm, negotiation,
idle}``, the dPRO attribution.

Semantics:

* every node's start is the max over its predecessors' ends (plus its
  rank's step-start skew floor); a global comm node therefore starts
  when the LAST participating rank arrives — negotiation waits are an
  *output* of the schedule, not an input;
* by default a rank's chain is fully serial (comm blocks the host, which
  is what the measured trace shows); ``overlap=True`` rebuilds edges so
  comm nodes stop occupying their ranks' serial threads and only gate
  the end of step — the "perfect overlap" what-if;
* ``dur_overrides`` / ``base_overrides`` let scenarios re-cost nodes
  (bandwidth scaling, straggler removal) without mutating the DAG.

The critical path is recovered by walking back from the sink through
each node's *determining* predecessor (the one whose end equals the
node's start).  By construction the path has no internal waiting: every
µs of the step's makespan is attributed to some node on it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .stitcher import StepDAG

_EPS = 1e-6


@dataclasses.dataclass
class Schedule:
    start: Dict[int, float]
    end: Dict[int, float]
    dur: Dict[int, float]
    preds: Dict[int, List[int]]
    sink: int
    makespan: float
    rank_end: Dict[int, int]        # rank -> its end-sentinel node id
    overlap: bool


def build_edges(dag: StepDAG, overlap: bool = False,
                extra_preds: Optional[Dict[int, List[int]]] = None,
                ) -> Tuple[Dict[int, List[int]], Dict[int, int], int]:
    """``(preds, rank_end_sentinels, sink)`` — sentinel ids live past
    ``len(dag.nodes)`` and have zero duration.

    ``extra_preds`` merges additional dependency edges into the derived
    set — the simulator's comm-CHANNEL serialization: under
    ``overlap=True`` collectives stop blocking host threads, but a real
    ICI domain still runs one collective at a time, so the bucketed
    what-ifs chain their bucket nodes here (bucket ``i+1`` cannot enter
    the wire before bucket ``i`` leaves it)."""
    preds: Dict[int, List[int]] = {n.nid: [] for n in dag.nodes}
    next_id = len(dag.nodes)
    rank_end: Dict[int, int] = {}

    for rank, chain in dag.chains.items():
        prev: Optional[int] = None      # last node holding the serial thread
        comms: List[int] = []
        for nid in chain:
            node = dag.nodes[nid]
            if node.kind == "comm":
                comms.append(nid)
                # readiness edge from this rank's chain position
                rp = dag.ready_pred.get(nid, {}).get(rank)
                if rp is not None:
                    preds[nid].append(rp)
                if not overlap:
                    prev = nid          # comm blocks the host thread
                # overlap: prev stays the preceding compute — the next
                # compute segment no longer waits for the collective
            else:
                if prev is not None:
                    preds[nid].append(prev)
                elif overlap and comms:
                    pass                # chain starts with comm: floor only
                prev = nid
        end_id = next_id
        next_id += 1
        rank_end[rank] = end_id
        preds[end_id] = []
        if prev is not None:
            preds[end_id].append(prev)
        if overlap:
            # the step still needs every collective result
            preds[end_id].extend(c for c in comms
                                 if c not in preds[end_id])
    sink = next_id
    preds[sink] = list(rank_end.values())
    if extra_preds:
        for nid, ps in extra_preds.items():
            cur = preds.setdefault(nid, [])
            cur.extend(p for p in ps if p not in cur)
    return preds, rank_end, sink


def schedule(dag: StepDAG, *, overlap: bool = False,
             dur_overrides: Optional[Dict[int, float]] = None,
             base_overrides: Optional[Dict[int, float]] = None,
             extra_preds: Optional[Dict[int, List[int]]] = None) -> Schedule:
    """Kahn-order discrete-event pass over the DAG."""
    preds, rank_end, sink = build_edges(dag, overlap=overlap,
                                        extra_preds=extra_preds)
    durs = {n.nid: n.dur_us for n in dag.nodes}
    if dur_overrides:
        durs.update(dur_overrides)
    for sid in list(rank_end.values()) + [sink]:
        durs[sid] = 0.0
    bases = dict(dag.rank_base_us)
    if base_overrides:
        bases.update(base_overrides)

    def floor(nid: int) -> float:
        if nid < len(dag.nodes):
            node = dag.nodes[nid]
            if node.rank is not None:
                return bases.get(node.rank, 0.0)
            if node.kind == "comm" and node.ranks:
                return max(bases.get(r, 0.0) for r in node.ranks)
        return 0.0

    succs: Dict[int, List[int]] = {nid: [] for nid in preds}
    indeg: Dict[int, int] = {nid: len(ps) for nid, ps in preds.items()}
    for nid, ps in preds.items():
        for p in ps:
            succs[p].append(nid)
    ready = [nid for nid, d in indeg.items() if d == 0]
    start: Dict[int, float] = {}
    end: Dict[int, float] = {}
    done = 0
    while ready:
        nid = ready.pop()
        done += 1
        s = max([end[p] for p in preds[nid]] + [floor(nid)], default=0.0)
        start[nid] = s
        end[nid] = s + durs[nid]
        for nxt in succs[nid]:
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                ready.append(nxt)
    if done != len(preds):
        raise ValueError(
            f"step DAG has a cycle ({len(preds) - done} unscheduled "
            "nodes) — inconsistent collective order across ranks?"
        )
    return Schedule(start=start, end=end, dur=durs, preds=preds,
                    sink=sink, makespan=end[sink], rank_end=rank_end,
                    overlap=overlap)


def critical_path(dag: StepDAG, sched: Schedule) -> List[int]:
    """Real node ids (sentinels dropped) along the determining chain,
    source→sink order.  Ties break toward the lowest node id so the path
    is deterministic across runs."""
    path: List[int] = []
    cur = sched.sink
    while True:
        ps = sched.preds.get(cur, [])
        if not ps:
            break
        det = max(ps, key=lambda p: (sched.end[p], -p))
        if sched.end[det] + _EPS < sched.start[cur]:
            break                       # start was set by the rank floor
        cur = det
        if cur < len(dag.nodes) and sched.dur[cur] > _EPS:
            path.append(cur)
    path.reverse()
    return path


def attribute(dag: StepDAG, sched: Schedule) -> Dict[str, dict]:
    """Where the step time went.

    ``per_rank``: for each rank, ``compute`` (its segments), ``comm``
    (collectives it participates in, when they block its thread),
    ``negotiation`` (Σ comm start − its own arrival: time spent waiting
    for the rest of the job), and ``idle`` (everything else up to the
    step makespan — start skew and post-finish wait for slower ranks).

    ``per_tensor``: per collective, payload/duration plus each rank's
    wait and the max−min ``spread_us`` — the merge-layer straggler
    numbers, now derived from the *scheduled* DAG so every what-if
    reprices them consistently.
    """
    per_rank: Dict[str, dict] = {}
    per_tensor: Dict[str, dict] = {}
    for rank, chain in dag.chains.items():
        compute = comm = nego = 0.0
        for nid in chain:
            node = dag.nodes[nid]
            if node.kind == "compute":
                compute += sched.dur[nid]
            else:
                if not sched.overlap:
                    comm += sched.dur[nid]
                rp = dag.ready_pred.get(nid, {}).get(rank)
                own_ready = sched.end[rp] if rp is not None else \
                    dag.rank_base_us.get(rank, 0.0)
                wait = max(sched.start[nid] - own_ready, 0.0)
                nego += wait
                key = node.label or (node.tensor or str(nid))
                t = per_tensor.setdefault(key, {
                    "tensor": node.tensor,
                    "op": node.op,
                    "bytes": node.nbytes,
                    "comm_us": round(sched.dur[nid], 3),
                    "per_rank_wait_us": {},
                })
                t["per_rank_wait_us"][str(rank)] = round(wait, 3)
        total = sched.makespan - dag.rank_base_us.get(rank, 0.0)
        idle = max(total - compute - comm - nego, 0.0)
        per_rank[str(rank)] = {
            "compute_us": round(compute, 3),
            "comm_us": round(comm, 3),
            "negotiation_us": round(nego, 3),
            "idle_us": round(idle, 3),
        }
    for t in per_tensor.values():
        waits = list(t["per_rank_wait_us"].values())
        t["spread_us"] = round(max(waits) - min(waits), 3) if waits else 0.0
        if len(waits) >= 2:
            # the rank that waited least arrived last — merge.py semantics
            t["straggler_rank"] = int(min(
                t["per_rank_wait_us"], key=t["per_rank_wait_us"].get))
    return {"per_rank": per_rank, "per_tensor": per_tensor}


def describe_path(dag: StepDAG, sched: Schedule,
                  path: List[int]) -> List[dict]:
    """JSON-friendly critical-path rows."""
    rows = []
    for nid in path:
        node = dag.nodes[nid]
        rows.append({
            "kind": node.kind,
            "rank": node.rank if node.kind == "compute" else None,
            "ranks": list(node.ranks) if node.kind == "comm" else None,
            "tensor": node.tensor,
            "op": node.op,
            "label": node.label,
            "start_us": round(sched.start[nid], 3),
            "dur_us": round(sched.dur[nid], 3),
        })
    return rows
