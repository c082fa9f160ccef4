"""What-if simulation: re-run a stitched step DAG under modified
assumptions and rank the scenarios by predicted speedup — the port of
``horovod_tpu/timeline/replay/simulator.py``.

This is the payoff of the whole byteprofile→stitch→replay chain: the
merge can say "rank 3 is late", but only replay can say what fixing it
is *worth*.  Each scenario rewrites one assumption and re-schedules the
same DAG (critical_path.schedule):

* ``remove_straggler_rank_<r>`` — the blamed rank's compute segments are
  clamped to the fastest rank's matching segments (matched by segment
  label, i.e. which tensor the segment feeds), as if its slowdown —
  thermal throttling, a noisy neighbor, input skew — were gone;
* ``ici_bandwidth_x<F>`` — every collective is re-costed with the α–β
  model *calibrated per node*: the measured duration is split into an α
  share (hop latency, from the ring-hop count) and a β share (bytes on
  the wire), and only β shrinks with bandwidth — exactly how the comm
  report models scaling (comm_report.predict_collective_us is the shared
  cost model);
* ``overlap_comm`` — collectives stop blocking their ranks' host
  threads and only gate the end of step (perfect compute/comm overlap,
  the upper bound fusion+async dispatch chase);
* ``fuse_all_comm`` — all collectives in the step re-batched into one
  bucket: one α, summed β, readiness gated by the LAST gradient — the
  fusion-buffer ceiling (bucket re-batching is the reference's whole
  fusion rationale);
* ``fuse_buckets_<k>`` — the *implementable* middle ground the
  profile-guided planner (optim/profile_guided.py) consumes: the step's
  collectives re-batched into ``k`` explicit buckets that dispatch on a
  serialized comm channel while compute proceeds (two-thread model: one
  host/compute thread per rank, ONE wire).  The bucket search is
  agglomerative — start from singletons in gradient-ready order, merge
  the adjacent pair that most improves the replayed makespan — and every
  ``fuse_buckets_*`` scenario carries a machine-readable ``plan``
  payload (bucket membership by tensor name, dispatch order, predicted
  step µs) so the planner can turn the ranking into live knob settings.

Predictions are *calibrated replays*: the baseline is the DAG replayed
with measured durations, so a scenario's delta isolates exactly the
assumption it changes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..comm_report import (
    DEFAULT_DCN_BYTES_PER_SEC, DEFAULT_DCN_HOP_LATENCY,
    DEFAULT_ICI_BYTES_PER_SEC, DEFAULT_ICI_HOP_LATENCY, TopologySpec,
    _link_volume, _ring_hops, compression_overhead_us,
    compression_scale_exchange, compression_terms_us,
    compression_wire_ratio, predict_collective_us,
)
from .critical_path import Schedule, attribute, schedule
from .stitcher import Node, StepDAG, _dtype_bytes

#: single-sourced with comm_report's TopologySpec defaults (NVLink 4)
DEFAULT_HOP_LATENCY_US = DEFAULT_ICI_HOP_LATENCY * 1e6

#: wire formats the compression what-ifs and the per-bucket choice
#: search rank (ops/compression.py registry names priced by
#: comm_report.COMPRESSION_MODEL)
COMPRESSION_CANDIDATES = ("int8", "fp8", "bf16")


@dataclasses.dataclass
class CostModel:
    """α–β parameters every scenario prices collectives with."""

    world: int
    ici_bytes_per_sec: float = DEFAULT_ICI_BYTES_PER_SEC
    hop_latency_us: float = DEFAULT_HOP_LATENCY_US
    #: two-level (ICI/DCN) shape parameters — local_size <= 1 disables
    #: the two_level_comm what-if (no hierarchy to exploit)
    local_size: int = 1
    dcn_bytes_per_sec: float = DEFAULT_DCN_BYTES_PER_SEC
    dcn_hop_latency_us: float = DEFAULT_DCN_HOP_LATENCY * 1e6

    @classmethod
    def from_topology(cls, spec: TopologySpec) -> "CostModel":
        """The calibrated-replay cost model for one topology spec —
        the projection engine's constructor (every α–β/tier number
        comes from the shared ``TopologySpec``, never re-declared)."""
        return cls(world=spec.world,
                   ici_bytes_per_sec=spec.ici_bytes_per_sec,
                   hop_latency_us=spec.ici_hop_latency_us,
                   local_size=spec.local_size,
                   dcn_bytes_per_sec=spec.dcn_bytes_per_sec,
                   dcn_hop_latency_us=spec.dcn_hop_latency_us)

    @property
    def topology(self) -> TopologySpec:
        """This model's parameters as the shared spec object."""
        return TopologySpec(world=self.world, local_size=self.local_size,
                            ici_bytes_per_sec=self.ici_bytes_per_sec,
                            ici_hop_latency_us=self.hop_latency_us,
                            dcn_bytes_per_sec=self.dcn_bytes_per_sec,
                            dcn_hop_latency_us=self.dcn_hop_latency_us)

    def alpha_us(self, node: Node) -> float:
        return _ring_hops(node.op or "all-reduce",
                          self.world) * self.hop_latency_us

    def beta_us(self, node: Node) -> Optional[float]:
        if not node.nbytes:
            return None
        return _link_volume(node.op or "all-reduce", node.nbytes,
                            self.world) / self.ici_bytes_per_sec * 1e6

    def predict_us(self, node: Node) -> Optional[float]:
        if not node.nbytes:
            return None
        return predict_collective_us(
            node.op or "all-reduce", node.nbytes, self.world,
            ici_bytes_per_sec=self.ici_bytes_per_sec,
            ici_hop_latency=self.hop_latency_us * 1e-6)

    def calibrated_beta_us(self, node: Node) -> float:
        """The measured duration's bandwidth-dependent share: measured
        minus the α floor (never negative).  Calibration keeps what-ifs
        honest on hardware whose effective bandwidth differs from the
        datasheet — the model shape is analytic, the level is measured."""
        return max(node.dur_us - self.alpha_us(node), 0.0)

    # -- wire-efficiency tier ------------------------------------------------
    def compressible(self, node: Node) -> bool:
        """Float payloads compress; integer/bool payloads ride as-is
        (the compressors gate the same way, ops/compression.py)."""
        if node.kind != "comm" or not node.nbytes:
            return False
        d = str(node.dtype) if node.dtype else "float32"
        return d.startswith(("float", "bfloat"))

    def compression_ratio(self, node: Node, compression: str) -> float:
        orig = _dtype_bytes(node.dtype)
        return compression_wire_ratio(compression, orig)

    def compressed_dur_us(self, node: Node, compression: str) -> float:
        """Calibrated compressed cost: the measured β share shrinks by
        the wire ratio; quantize/dequantize and the quantizers' scalar
        scale exchange (one all-reduce α) are added — the same curve
        predict_collective_us prices, anchored on the measured level
        (terms from the shared comm_report.compression_terms_us)."""
        if not self.compressible(node):
            return node.dur_us
        ratio, qd, scale = compression_terms_us(
            compression, node.nbytes or 0, self.world,
            self.hop_latency_us, _dtype_bytes(node.dtype))
        return self.alpha_us(node) + self.calibrated_beta_us(node) * ratio \
            + qd + scale

    def two_level_dur_us(self, node: Node,
                         compression: Optional[str] = None,
                         spec: Optional[TopologySpec] = None) -> float:
        """Model-priced two-level cost (parallel/hierarchical.py shape):
        the measured flat duration carries no information about the
        ICI/DCN split, so this scenario is pure predict_collective_us —
        the fixture-checkable arithmetic, not a calibrated replay.
        ``spec`` supplies the hierarchy to price against (default: this
        model's own) — the what-if can evaluate two-level for a target
        topology the trace never ran on."""
        if node.kind != "comm" or not node.nbytes \
                or (node.op or "all-reduce") != "all-reduce":
            return node.dur_us
        spec = spec if spec is not None else self.topology
        return predict_collective_us(
            "all-reduce", node.nbytes, self.world,
            ici_bytes_per_sec=spec.ici_bytes_per_sec,
            ici_hop_latency=spec.ici_hop_latency_us * 1e-6,
            compression=compression if self.compressible(node) else None,
            orig_itemsize=_dtype_bytes(node.dtype),
            two_level=True, local_size=spec.local_size,
            dcn_bytes_per_sec=spec.dcn_bytes_per_sec,
            dcn_hop_latency=spec.dcn_hop_latency_us * 1e-6)

    def two_level_possible(self) -> bool:
        return self.topology.two_level_possible()


def identify_straggler(dag: StepDAG, sched: Schedule) -> Optional[int]:
    """The rank that cost the others the most negotiation wait: per
    collective, the last-arriving rank is blamed for that tensor's
    max−min wait spread; highest total blame wins."""
    blame: Dict[int, float] = {r: 0.0 for r in dag.chains}
    for cid, rp in dag.ready_pred.items():
        if len(rp) < 2:
            continue
        arrivals = {}
        for rank, pred in rp.items():
            arrivals[rank] = sched.end[pred] if pred is not None else \
                dag.rank_base_us.get(rank, 0.0)
        last = max(arrivals, key=arrivals.get)
        blame[last] += max(arrivals.values()) - min(arrivals.values())
    if not blame or max(blame.values()) <= 0.0:
        return None
    return max(blame, key=blame.get)


# ---------------------------------------------------------------------------
# scenario builders
# ---------------------------------------------------------------------------
def bandwidth_overrides(dag: StepDAG, cm: CostModel,
                        factor: float) -> Dict[int, float]:
    return {
        n.nid: cm.alpha_us(n) + cm.calibrated_beta_us(n) / factor
        for n in dag.nodes if n.kind == "comm"
    }


def remove_rank_overrides(dag: StepDAG, rank: int
                          ) -> Dict[str, Dict[int, float]]:
    """Clamp ``rank``'s compute segments to the fastest rank's matching
    segment (by label); its step-start skew is clamped to the earliest
    rank's."""
    best_by_label: Dict[str, float] = {}
    for r, chain in dag.chains.items():
        if r == rank:
            continue
        for nid in chain:
            node = dag.nodes[nid]
            if node.kind == "compute":
                cur = best_by_label.get(node.label)
                best_by_label[node.label] = node.dur_us if cur is None \
                    else min(cur, node.dur_us)
    durs: Dict[int, float] = {}
    for nid in dag.chains.get(rank, ()):
        node = dag.nodes[nid]
        if node.kind == "compute" and node.label in best_by_label:
            durs[nid] = min(node.dur_us, best_by_label[node.label])
    bases = {rank: min(dag.rank_base_us.values())}
    return {"dur_overrides": durs, "base_overrides": bases}


def fused_dag(dag: StepDAG, cm: CostModel) -> Optional[StepDAG]:
    """The step DAG with every collective re-batched into ONE bucket:
    per rank the bucket sits where its last collective sat (readiness =
    the last gradient's arrival — fusion can't launch before the bucket
    fills), computes keep their relative order, and the bucket costs one
    α plus the summed calibrated β of its members.  None when there are
    fewer than two collectives (nothing to fuse)."""
    comm_nodes = [n for n in dag.nodes if n.kind == "comm"]
    if len(comm_nodes) < 2:
        return None
    alpha = max(cm.alpha_us(n) for n in comm_nodes)
    beta = sum(cm.calibrated_beta_us(n) for n in comm_nodes)
    total_bytes = sum(n.nbytes or 0 for n in comm_nodes) or None

    nodes: List[Node] = []
    chains: Dict[int, List[int]] = {}
    ready_pred: Dict[int, Dict[int, Optional[int]]] = {}
    id_map: Dict[int, int] = {}

    def clone(node: Node) -> int:
        new = dataclasses.replace(node, nid=len(nodes))
        nodes.append(new)
        id_map[node.nid] = new.nid
        return new.nid

    fused = Node(0, "comm", alpha + beta, tensor="<fused>",
                 op="all-reduce", nbytes=total_bytes, label="comm:<fused>",
                 ranks=tuple(sorted({r for n in comm_nodes
                                     for r in n.ranks})))
    fused_id: Optional[int] = None
    for rank, chain in dag.chains.items():
        old_comms = [nid for nid in chain
                     if dag.nodes[nid].kind == "comm"]
        last_comm = old_comms[-1] if old_comms else None
        new_chain: List[int] = []
        for nid in chain:
            node = dag.nodes[nid]
            if node.kind == "compute":
                new_chain.append(clone(node))
            elif nid == last_comm:
                if fused_id is None:
                    fused.nid = len(nodes)
                    nodes.append(fused)
                    fused_id = fused.nid
                    ready_pred[fused_id] = {}
                # the bucket fills when this rank's LAST gradient is
                # ready: its readiness pred is whatever precedes it in
                # the rebuilt (compute-only-so-far) chain
                ready_pred[fused_id][rank] = new_chain[-1] if new_chain \
                    else None
                new_chain.append(fused_id)
        chains[rank] = new_chain
    return StepDAG(
        step=dag.step, t0_us=dag.t0_us, nodes=nodes, chains=chains,
        ready_pred=ready_pred, rank_base_us=dict(dag.rank_base_us),
        measured_span_us=dict(dag.measured_span_us), world=dag.world,
    )


def comm_channel_order(dag: StepDAG) -> List[int]:
    """Comm node ids in collective dispatch order.  Ranks dispatch
    collectives in one consistent order (anything else deadlocks the real
    job and the linter/sanitizer reject it), so the lowest rank's chain
    order IS the wire order; comm nodes a subset rank never joined are
    appended in nid order."""
    first = min(dag.chains) if dag.chains else None
    order = [nid for nid in dag.chains.get(first, ())
             if dag.nodes[nid].kind == "comm"]
    seen = set(order)
    order.extend(n.nid for n in dag.nodes
                 if n.kind == "comm" and n.nid not in seen)
    return order


def _bucket_dur_us(cm: CostModel, members: List[Node],
                   compression: Optional[str]) -> float:
    """One bucket's cost: max member α + summed calibrated β (scaled by
    the wire ratio when compressed) + the members' quantize/dequantize
    overhead + ONE scale-exchange α for the whole bucket (the per-tensor
    scale scalars ride one fused collective)."""
    alpha = max(cm.alpha_us(m) for m in members)
    if not compression:
        return alpha + sum(cm.calibrated_beta_us(m) for m in members)
    beta = qd = 0.0
    any_scale = False
    for m in members:
        if cm.compressible(m):
            beta += cm.calibrated_beta_us(m) * \
                cm.compression_ratio(m, compression)
            qd += compression_overhead_us(m.nbytes or 0, compression)
            any_scale = any_scale or compression_scale_exchange(compression)
        else:
            beta += cm.calibrated_beta_us(m)
    scale = (_ring_hops("all-reduce", cm.world) * cm.hop_latency_us
             if any_scale else 0.0)
    return alpha + beta + qd + scale


def bucketed_dag(dag: StepDAG, cm: CostModel,
                 buckets: List[List[int]],
                 bucket_compression: Optional[List[Optional[str]]] = None):
    """The step DAG with the given comm nodes re-batched into explicit
    buckets (each a list of original comm node ids): per rank a bucket
    node sits where its LAST member sat, earlier members vanish, and the
    bucket costs one α (the members' max) plus the summed calibrated β.
    Readiness per rank is the last compute segment preceding the bucket's
    last member — a bucket can't launch before it fills.
    ``bucket_compression`` (registry names aligned with ``buckets``)
    prices a per-bucket wire format via :func:`_bucket_dur_us` — the
    planner's compression choice replayed on the same DAG.

    Returns ``(new_dag, bucket_ids, chain_edges)`` where ``chain_edges``
    serializes the bucket nodes on one comm channel in dispatch order —
    pass it as ``schedule(..., overlap=True, extra_preds=chain_edges)``
    for the two-thread (compute ∥ wire) replay the profile-guided plans
    are priced with."""
    order = comm_channel_order(dag)
    pos = {nid: i for i, nid in enumerate(order)}
    bucket_of: Dict[int, int] = {}
    for bi, members in enumerate(buckets):
        for nid in members:
            bucket_of[nid] = bi
    # comm nodes not covered by any bucket ride as singletons
    for nid in order:
        if nid not in bucket_of:
            buckets = buckets + [[nid]]
            bucket_of[nid] = len(buckets) - 1

    nodes: List[Node] = []
    chains: Dict[int, List[int]] = {}
    ready_pred: Dict[int, Dict[int, Optional[int]]] = {}
    bucket_ids: Dict[int, int] = {}         # bucket index -> new node id

    def bucket_node(bi: int) -> Node:
        members = [dag.nodes[nid] for nid in buckets[bi]]
        comp = bucket_compression[bi] if bucket_compression is not None \
            and bi < len(bucket_compression) else None
        nbytes = sum(m.nbytes or 0 for m in members) or None
        names = ",".join(m.tensor or m.label for m in members)
        tag = f"|{comp}" if comp else ""
        return Node(0, "comm", _bucket_dur_us(cm, members, comp),
                    tensor=f"<bucket{bi}>",
                    op=members[0].op or "all-reduce", nbytes=nbytes,
                    label=f"comm:<bucket{bi}:{names}{tag}>",
                    ranks=tuple(sorted({r for m in members
                                        for r in m.ranks})))

    for rank, chain in dag.chains.items():
        # the member that appears LAST in this rank's chain, per bucket
        last_member: Dict[int, int] = {}
        for nid in chain:
            if nid in bucket_of:
                last_member[bucket_of[nid]] = nid
        new_chain: List[int] = []
        last_compute: Optional[int] = None
        for nid in chain:
            node = dag.nodes[nid]
            if node.kind == "compute":
                new = dataclasses.replace(node, nid=len(nodes))
                nodes.append(new)
                new_chain.append(new.nid)
                last_compute = new.nid
                continue
            bi = bucket_of[nid]
            if last_member.get(bi) != nid:
                continue                    # folded into a later position
            if bi not in bucket_ids:
                bn = bucket_node(bi)
                bn.nid = len(nodes)
                nodes.append(bn)
                bucket_ids[bi] = bn.nid
                ready_pred[bn.nid] = {}
            bid = bucket_ids[bi]
            ready_pred[bid][rank] = last_compute
            new_chain.append(bid)
        chains[rank] = new_chain

    # wire order: buckets sorted by their last member's dispatch position
    wire = sorted(bucket_ids,
                  key=lambda bi: max(pos[nid] for nid in buckets[bi]))
    chain_edges: Dict[int, List[int]] = {}
    for prev_bi, next_bi in zip(wire, wire[1:]):
        chain_edges[bucket_ids[next_bi]] = [bucket_ids[prev_bi]]
    new_dag = StepDAG(
        step=dag.step, t0_us=dag.t0_us, nodes=nodes, chains=chains,
        ready_pred=ready_pred, rank_base_us=dict(dag.rank_base_us),
        measured_span_us=dict(dag.measured_span_us), world=dag.world,
    )
    ordered_ids = [bucket_ids[bi] for bi in wire]
    return new_dag, ordered_ids, chain_edges


def _bucket_plan(dag: StepDAG, partition: List[List[int]],
                 predicted_us: float,
                 compression: Optional[List[Optional[str]]] = None) -> dict:
    """Machine-readable plan payload for one bucketing — the contract
    optim/profile_guided.py consumes (docs/autotune.md).  ``compression``
    (aligned with ``partition``) records the per-bucket wire-format
    decision; it is re-ordered with the buckets into wire order."""
    order = comm_channel_order(dag)
    pos = {nid: i for i, nid in enumerate(order)}
    idx = sorted(range(len(partition)),
                 key=lambda i: max(pos[n] for n in partition[i]))
    wire = [partition[i] for i in idx]
    plan = {
        "num_buckets": len(wire),
        "buckets": [[dag.nodes[n].tensor or dag.nodes[n].label
                     for n in sorted(b, key=pos.get)] for b in wire],
        "bucket_bytes": [sum(dag.nodes[n].nbytes or 0 for n in b) or None
                         for b in wire],
        "overlap": True,
        "predicted_step_us": round(predicted_us, 3),
    }
    if compression is not None:
        plan["compression"] = [compression[i] for i in idx]
    return plan


def compression_choice_search(dag: StepDAG, cm: CostModel,
                              partition: List[List[int]],
                              candidates=COMPRESSION_CANDIDATES):
    """Per-bucket wire-format choice for a FIXED bucket partition:
    greedy over buckets in descending payload order, picking per bucket
    the candidate that most improves the two-thread replayed makespan
    (ties broken toward the cheaper bucket duration, so a bucket hidden
    behind the critical path still takes the best format).  Staged
    after the partition search (docs/autotune.md): the joint
    partition × format space is exponential, and the partition choice
    is driven by α amortization while the format choice is driven by β
    — factoring them keeps both searches hand-checkable.

    Returns ``(compression, makespan_us)`` with ``compression`` aligned
    to ``partition`` (None = uncompressed)."""
    comp: List[Optional[str]] = [None] * len(partition)

    def evaluate(c):
        bdag, _ids, chain = bucketed_dag(dag, cm, partition,
                                         bucket_compression=c)
        return schedule(bdag, overlap=True, extra_preds=chain).makespan

    def bucket_dur(bi, name):
        return _bucket_dur_us(cm, [dag.nodes[n] for n in partition[bi]],
                              name)

    best_m = evaluate(comp)
    order = sorted(range(len(partition)), key=lambda bi: -sum(
        dag.nodes[n].nbytes or 0 for n in partition[bi]))
    for bi in order:
        if not any(cm.compressible(dag.nodes[n]) for n in partition[bi]):
            continue
        best = (best_m, bucket_dur(bi, comp[bi]), comp[bi])
        for cand in candidates:
            trial = list(comp)
            trial[bi] = cand
            key = (evaluate(trial), bucket_dur(bi, cand), cand)
            if key[:2] < best[:2]:
                best = key
        if best[2] != comp[bi]:
            comp[bi] = best[2]
            best_m = best[0]
    return comp, best_m


def bucket_plan_search(dag: StepDAG, cm: CostModel,
                       max_initial: int = 64,
                       patience: int = 8) -> List[dict]:
    """Agglomerative search over contiguous bucketings of the comm
    sequence: start from singletons in dispatch order, repeatedly merge
    the adjacent pair whose fusion most improves the two-thread replayed
    makespan, and record the best partition seen at every bucket count.
    Returns one row per bucket count (``num_buckets``,
    ``predicted_step_us``, ``plan``), best-first.

    The descent stops early once ``patience`` consecutive merge levels
    fail to improve on the best makespan seen — past the optimum, every
    further merge only serializes more payload behind one α, so the
    abandoned tail of the table is diagnostics we already know lose
    (bounds the O(n²) full-DAG replays on big traces; the fixture's
    3-level table is far under the patience and stays complete)."""
    order = comm_channel_order(dag)
    if len(order) < 2:
        return []
    parts: List[List[int]] = [[nid] for nid in order]
    # very long steps: pre-merge the cheapest adjacent pairs so the
    # O(n^2) greedy stays bounded (the dropped granularity is logged in
    # the plan's num_buckets, not silently hidden)
    while len(parts) > max_initial:
        betas = [sum(cm.calibrated_beta_us(dag.nodes[n]) for n in b)
                 for b in parts]
        i = min(range(len(parts) - 1),
                key=lambda j: betas[j] + betas[j + 1])
        parts[i:i + 2] = [parts[i] + parts[i + 1]]

    def evaluate(partition: List[List[int]]) -> float:
        bdag, _ids, chain = bucketed_dag(dag, cm, partition)
        return schedule(bdag, overlap=True, extra_preds=chain).makespan

    results: List[dict] = []

    def record(partition: List[List[int]], makespan: float) -> None:
        row = _bucket_plan(dag, partition, makespan)
        # node-id partition, for the staged compression_choice_search
        # (tensor names in `buckets` are the plan contract; node ids are
        # this DAG's internals)
        row["node_partition"] = [list(b) for b in partition]
        results.append(row)

    best_seen = evaluate(parts)
    record(parts, best_seen)
    cur, stale = parts, 0
    while len(cur) > 1 and stale < patience:
        best: Optional[tuple] = None
        for i in range(len(cur) - 1):
            cand = cur[:i] + [cur[i] + cur[i + 1]] + cur[i + 2:]
            m = evaluate(cand)
            if best is None or m < best[0]:
                best = (m, cand)
        cur = best[1]
        record(cur, best[0])
        if best[0] < best_seen:
            best_seen, stale = best[0], 0
        else:
            stale += 1
    results.sort(key=lambda r: (r["predicted_step_us"], r["num_buckets"]))
    return results


# ---------------------------------------------------------------------------
# the what-if driver
# ---------------------------------------------------------------------------
def what_if(dag: StepDAG, cm: Optional[CostModel] = None,
            bandwidth_factors: tuple = (2.0, 4.0),
            plan_search: bool = True,
            topology: Optional[TopologySpec] = None) -> dict:
    """Baseline replay + every scenario, ranked by predicted speedup.

    ``plan_search=False`` skips the agglomerative bucket search (the
    `fuse_buckets_<k>` scenario + `bucket_search` table) — it is the
    expensive part on big traces (O(n²) full-DAG replays, patience-
    bounded), and a consumer after a straggler report doesn't need a
    fusion plan (`hvd_replay.py --no-plan-search`).

    ``topology`` supplies the hierarchy/tier assumptions the
    ``two_level_comm`` scenario is gated and priced on (default: the
    cost model's own) — so a trace captured on a FLAT world can still
    evaluate two-level reduction against a projected multi-host target
    (``hvd_replay --project``) instead of silently omitting it."""
    cm = cm or CostModel(world=dag.world)
    tl_spec = (topology if topology is not None
               else cm.topology).with_world(cm.world)
    base = schedule(dag)
    baseline_us = base.makespan
    scenarios: List[dict] = []

    def add(name: str, sched_, detail: str, plan: Optional[dict] = None
            ) -> None:
        predicted = sched_.makespan if isinstance(sched_, Schedule) \
            else float(sched_)
        row = {
            "scenario": name,
            "predicted_step_us": round(predicted, 3),
            "speedup_pct": round(
                (baseline_us - predicted) / baseline_us * 100.0, 2)
            if baseline_us > 0 else 0.0,
            "detail": detail,
        }
        if plan is not None:
            row["plan"] = plan
        scenarios.append(row)

    straggler = identify_straggler(dag, base)
    if straggler is not None:
        ov = remove_rank_overrides(dag, straggler)
        add(f"remove_straggler_rank_{straggler}",
            schedule(dag, dur_overrides=ov["dur_overrides"],
                     base_overrides=ov["base_overrides"]),
            f"rank {straggler}'s compute clamped to the fastest rank's "
            "matching segments")
    for f in bandwidth_factors:
        add(f"ici_bandwidth_x{f:g}",
            schedule(dag, dur_overrides=bandwidth_overrides(dag, cm, f)),
            f"β share of every collective divided by {f:g} "
            "(α latency floor kept)")
    add("overlap_comm", schedule(dag, overlap=True),
        "collectives no longer block host threads; they only gate "
        "step end")
    fdag = fused_dag(dag, cm)
    if fdag is not None:
        add("fuse_all_comm", schedule(fdag),
            "all collectives re-batched into one bucket: one α, "
            "summed β, launch gated by the last gradient")
    # wire-efficiency tier (docs/compression.md): every float payload
    # re-costed in one wire format — β scaled by the compression ratio,
    # quantize/dequantize and scale-exchange overheads added, all from
    # comm_report's COMPRESSION_MODEL (the same curve
    # predict_collective_us prices)
    for comp in COMPRESSION_CANDIDATES:
        overrides = {n.nid: cm.compressed_dur_us(n, comp)
                     for n in dag.nodes if cm.compressible(n)}
        if overrides:
            add(f"compress_{comp}", schedule(dag, dur_overrides=overrides),
                f"every float gradient quantized to {comp} on the wire "
                "(error-feedback residual carried, "
                "HVD_COMPRESSION=" + comp + ")")
    if tl_spec.two_level_possible():
        overrides = {
            n.nid: cm.two_level_dur_us(n, spec=tl_spec) for n in dag.nodes
            if n.kind == "comm" and n.nbytes
            and (n.op or "all-reduce") == "all-reduce"
        }
        if overrides:
            add("two_level_comm", schedule(dag, dur_overrides=overrides),
                f"two-level allreduce: ICI reduce-scatter over "
                f"{tl_spec.local_size} local ranks + DCN all-reduce on "
                "the shard + ICI all-gather (model-priced, "
                "HVD_TWO_LEVEL_ALLREDUCE=1)")
    search = bucket_plan_search(dag, cm) if plan_search else []
    if search:
        best = search[0]
        add(f"fuse_buckets_{best['num_buckets']}",
            best["predicted_step_us"],
            f"{best['num_buckets']} explicit fusion buckets dispatched "
            "on a serialized comm channel overlapping compute — the "
            "implementable plan the profile-guided tuner applies",
            plan=best)
        # staged wire-format choice on the winning partition: the
        # per-bucket compression decision the planner applies/verifies/
        # rolls back exactly like the fusion decision
        comp, m = compression_choice_search(dag, cm,
                                            best["node_partition"])
        if any(comp) and m < best["predicted_step_us"]:
            plan = _bucket_plan(dag, best["node_partition"], m,
                                compression=comp)
            chosen = ",".join(f"{c or 'none'}" for c in plan["compression"])
            add(f"fuse_buckets_{plan['num_buckets']}_compressed", m,
                f"the {plan['num_buckets']}-bucket plan with per-bucket "
                f"wire formats [{chosen}] — compression ranked against "
                "fusion on one scale",
                plan=plan)
    scenarios.sort(key=lambda s: s["predicted_step_us"])
    return {
        "baseline_replay_us": round(baseline_us, 3),
        "straggler_rank": straggler,
        "cost_model": {
            "world": cm.world,
            "ici_bytes_per_sec": cm.ici_bytes_per_sec,
            "hop_latency_us": cm.hop_latency_us,
            "local_size": tl_spec.local_size,
        },
        "scenarios": scenarios,
        "bucket_search": search,
    }


def attribution_with_baseline(dag: StepDAG) -> dict:
    """Convenience: baseline schedule's attribution (CLI/server path)."""
    return attribute(dag, schedule(dag))
