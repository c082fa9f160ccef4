"""Synthetic 2-rank fixture trace with a hand-computed critical path: the
port of ``horovod_tpu/timeline/replay/fixture.py``.

The replay engine's ground truth: a trace small enough to schedule by
hand, used by the tests.  The step, on the ALIGNED clock (rank 1's raw
timestamps are shifted −25 µs and its ``clock_sync.json`` carries
``offset_us=+25`` — alignment itself is under test):

::

    rank 0:  [compute 100][ wait 200        ][comm 50][compute 100]
    rank 1:  [compute 300 (straggler)       ][comm 50][compute  50]
             0         100                  300      350   400   450

* both ranks negotiate tensor ``g0`` (ALLREDUCE, 4 MiB: f32[1024,1024]
  from tensor_shapes.json); rank 0 arrives at 100, rank 1 at 300 — the
  collective starts at 300, so rank 0 waits 200 µs;
* hand-computed critical path: rank 1's 300 µs compute → the 50 µs
  collective → rank 0's 100 µs tail compute = **450 µs** makespan;
* hand-computed "remove straggler rank 1" what-if: rank 1's leading
  segment clamps to rank 0's 100 µs, the collective starts at 100,
  rank 0's tail ends at 100+50+100 = **250 µs**;
* hand-computed attribution: rank 0 {compute 200, comm 50,
  negotiation 200, idle 0}; rank 1 {compute 350, comm 50,
  negotiation 0, idle 50}.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from ..recorder import structure_dag, write_gml

TENSOR = "g0"
SHAPE = [1024, 1024]                     # f32 → 4 MiB payload
STEP_NO = 1

#: hand-computed ground truth asserted by --check and the tests
EXPECTED: Dict[str, object] = {
    "makespan_us": 450.0,
    "critical_path": [
        {"kind": "compute", "rank": 1, "dur_us": 300.0},
        {"kind": "comm", "tensor": TENSOR, "dur_us": 50.0},
        {"kind": "compute", "rank": 0, "dur_us": 100.0},
    ],
    "remove_straggler_us": 250.0,
    "straggler_rank": 1,
    "attribution": {
        "0": {"compute_us": 200.0, "comm_us": 50.0,
              "negotiation_us": 200.0, "idle_us": 0.0},
        "1": {"compute_us": 350.0, "comm_us": 50.0,
              "negotiation_us": 0.0, "idle_us": 50.0},
    },
    "tensor_bytes": 1024 * 1024 * 4,
}


def _events_rank0() -> List[dict]:
    t = TENSOR
    return [
        {"name": "NEGOTIATE_ALLREDUCE", "cat": t, "ph": "B", "ts": 100.0,
         "pid": 0, "tid": t},
        {"name": "NEGOTIATE_ALLREDUCE", "cat": t, "ph": "E", "ts": 300.0,
         "pid": 0, "tid": t},
        {"name": "ALLREDUCE", "cat": t, "ph": "X", "ts": 300.0,
         "dur": 50.0, "pid": 0, "tid": t},
        {"name": "STEP", "cat": f"step_{STEP_NO}", "ph": "X", "ts": 0.0,
         "dur": 450.0, "pid": 0, "tid": "step"},
    ]


def _events_rank1() -> List[dict]:
    # raw timestamps 25 µs BEHIND the aligned clock; clock_sync.json says
    # offset_us=+25, so merge/stitch shifts them back onto the shared one
    t = TENSOR
    off = -25.0
    return [
        {"name": "NEGOTIATE_ALLREDUCE", "cat": t, "ph": "B",
         "ts": 300.0 + off, "pid": 1, "tid": t},
        {"name": "NEGOTIATE_ALLREDUCE", "cat": t, "ph": "E",
         "ts": 300.0 + off, "pid": 1, "tid": t},
        {"name": "ALLREDUCE", "cat": t, "ph": "X", "ts": 300.0 + off,
         "dur": 50.0, "pid": 1, "tid": t},
        {"name": "STEP", "cat": f"step_{STEP_NO}", "ph": "X",
         "ts": 0.0 + off, "dur": 400.0, "pid": 1, "tid": "step"},
    ]


#: --- projection ground truth (hvd_replay --project --check) ---------------
#:
#: The digital twin projected from the SAME 2-rank trace, hand-computed
#: (timeline/replay/projection.py, distribution mode, the port's default
#: α–β of timeline/comm_report.py: NVLink hop 0.6 µs at 450 GB/s, the
#: cross-node tier 50 GB/s at 2.7 µs a hop):
#:
#: * **identity (world 2)**: nothing changes — 450.0 µs, bit-equal to
#:   the replay baseline (the regression anchor);
#: * **2× (world 4)**: ranks 0/2 get rank 0's chain, ranks 1/3 get
#:   rank 1's.  The collective re-prices with the calibrated split:
#:   α₂ = 2·(2−1)·0.6 = 1.2 µs, β_cal = 50 − 1.2 = 48.8 µs; link volume
#:   scales by [2·3/4] / [2·1/2] = 1.5 → β₄ = 73.2 µs; α₄ = 2·(4−1)·0.6
#:   = 3.6 µs → comm = **76.8 µs**.  Readiness still gates at 300 (ranks
#:   1/3), so the makespan = 300 + 76.8 + 100 = **476.8 µs** (efficiency
#:   450/476.8 = 0.9438);
#: * **world 6, local 2 × cross 3, two_level=on**: the flat measurement
#:   carries no tier split, so the collective is pure model
#:   (predict_collective_us two-level shape): local RS + AG over NVLink
#:   = 2 × 2 MiB/450 GB/s = 9.321 µs + 2 hops × 0.6 = 1.2 µs; cross
#:   all-reduce on the 2 MiB shard = (2·⅔·2 MiB)/50 GB/s = 55.924 µs + 4
#:   hops × 2.7 µs = 10.8 µs → comm = **77.245 µs**; makespan = 300 +
#:   77.245 + 100 = **477.245 µs**.
PROJECTION_EXPECTED: Dict[str, object] = {
    "identity_us": 450.0,
    "world4_us": 476.8,
    "world4_comm_us": 76.8,
    "world4_efficiency": 0.9438,
    "world6_local2_us": 477.245,
    "world6_comm_us": 77.245,
    "hop_latency_us": 0.6,
}


#: --- autotune ground truth (plan_from_trace on this trace) ---------------
#:
#: A second hand-computed 2-rank trace, symmetric across ranks (no
#: straggler, no clock skew) so the interesting structure is entirely in
#: the fusion/overlap economics.  Three gradients, hop latency 10 µs
#: (α = 2 hops × 10 = 20 µs per 2-rank ring all-reduce), calibrated
#: β = measured − α:
#:
#: ::
#:
#:     both ranks:  [A 100][g0 120][B 80][g1 50][C 20][g2 50][tail 20]
#:                  0     100     220   300    350   370    420    440
#:
#: Two-thread replay (compute thread ∥ one serialized comm channel):
#: computes run back-to-back (A 0–100, B 100–180, C 180–200, tail
#: 200–220) and each bucket launches at max(its fill time, channel
#: free):
#:
#: * 3 buckets (no fusion):   g0 100→220, g1 220→270, g2 270→320 → 320
#: * 2 buckets {g0},{g1,g2}:  g0 100→220, {g1,g2} = α20+β60 = 80,
#:   220→300 → **300 µs** (the uncompressed optimum)
#: * 1 bucket  {g0,g1,g2}:    fills at 200, α20+β160 = 180 → 380
#: * fuse_all_comm (serial):  200 compute + 180 bucket + 20 tail = 400
#: * overlap_comm (free channels, unimplementable upper bound): 250
#:
#: Wire-efficiency tier (comm_report.COMPRESSION_MODEL constants:
#: int8 ¼β + 1 µs/MiB qd + one scale-exchange α; fp8 ¼β + 1.5 µs/MiB
#: + scale α; bf16 ½β + 0.5 µs/MiB, no scale) on the 2-bucket
#: partition — g0 is 4 MiB f32 (β_cal 100), {g1,g2} 0.5 MiB (β 60):
#:
#: * bucket {g0}:      none 120 | int8 20+25+4+20 = **69** |
#:   fp8 20+25+6+20 = 71 | bf16 20+50+2 = 72
#: * bucket {g1,g2}:   none 80 | int8 20+15+0.5+20 = 55.5 |
#:   fp8 55.75 | bf16 20+30+0.25 = **50.25**
#: * chosen plan [int8, bf16]: g0 100→169, {g1,g2} fills 200,
#:   200→250.25 → **250.25 µs** (the staged optimum — int8 on the
#:   largest gradient, cast-only bf16 on the small bucket where the
#:   scale-exchange α would not pay)
#: * whole-wire compress_int8 (serial replay): 220 compute +
#:   69+47.75+47.75 = **384.5**
AUTOTUNE_TENSORS = ("g0", "g1", "g2")
AUTOTUNE_SHAPES = {"g0": [1024, 1024], "g1": [256, 256], "g2": [256, 256]}
AUTOTUNE_STEP_NO = 1
AUTOTUNE_HOP_US = 10.0

AUTOTUNE_EXPECTED: Dict[str, object] = {
    "baseline_us": 440.0,
    "optimal_num_buckets": 2,
    "optimal_buckets": [["g0"], ["g1", "g2"]],
    # uncompressed bucket economics (the bucket_search table rows)
    "uncompressed_step_us": 300.0,
    "uncompressed_speedup_pct": 31.82,
    "bucket_search_us": {1: 380.0, 2: 300.0, 3: 320.0},
    # the staged wire-format choice on the winning partition — the plan
    # the closed loop must recover END TO END: int8 on the largest
    # gradient, bf16 on the small bucket (hand math in the block above)
    "optimal_compression": ["int8", "bf16"],
    "predicted_step_us": 250.25,
    "predicted_speedup_pct": 43.12,
    "compress_int8_us": 384.5,
    "fuse_all_us": 400.0,
    "overlap_us": 250.0,
    "hop_latency_us": AUTOTUNE_HOP_US,
    "tensor_bytes": {"g0": 1024 * 1024 * 4, "g1": 256 * 256 * 4,
                     "g2": 256 * 256 * 4},
}


def _autotune_events() -> List[dict]:
    """One rank's step (both ranks are identical): serial comm blocks the
    host, negotiation is instantaneous (B == E == span start)."""
    evs: List[dict] = [
        {"name": "STEP", "cat": f"step_{AUTOTUNE_STEP_NO}", "ph": "X",
         "ts": 0.0, "dur": 440.0, "tid": "step"},
    ]
    for tensor, ts, dur in (("g0", 100.0, 120.0), ("g1", 300.0, 50.0),
                            ("g2", 370.0, 50.0)):
        evs += [
            {"name": "NEGOTIATE_ALLREDUCE", "cat": tensor, "ph": "B",
             "ts": ts, "tid": tensor},
            {"name": "NEGOTIATE_ALLREDUCE", "cat": tensor, "ph": "E",
             "ts": ts, "tid": tensor},
            {"name": "ALLREDUCE", "cat": tensor, "ph": "X", "ts": ts,
             "dur": dur, "tid": tensor},
        ]
    return evs


def write_autotune_fixture_trace(trace_dir: str) -> Dict[str, object]:
    """Materialize the autotune ground-truth trace (both ranks identical,
    offsets 0) and return :data:`AUTOTUNE_EXPECTED`."""
    names = list(AUTOTUNE_TENSORS)
    for rank in (0, 1):
        d = os.path.join(trace_dir, str(rank))
        os.makedirs(d, exist_ok=True)
        evs = [dict(ev, pid=rank) for ev in _autotune_events()]
        with open(os.path.join(d, "comm.json"), "w") as f:
            json.dump(evs, f, indent=1)
        with open(os.path.join(d, "clock_sync.json"), "w") as f:
            json.dump({"offset_us": 0.0, "rtt_us": 4.0, "samples": 8,
                       "rank": rank, "method": "fixture"}, f, indent=1)
        with open(os.path.join(d, "tensor_shapes.json"), "w") as f:
            json.dump(AUTOTUNE_SHAPES, f, indent=1)
        with open(os.path.join(d, "tensor_dtypes.json"), "w") as f:
            json.dump({t: "float32" for t in names}, f, indent=1)
        with open(os.path.join(d, "gradient_name_list.json"), "w") as f:
            json.dump(names, f, indent=1)
        with open(os.path.join(d, "metadata.json"), "w") as f:
            json.dump({"rank": rank, "size": 2,
                       "model": "autotune-fixture"}, f, indent=1)
        nodes, edges = structure_dag(names)
        write_gml(nodes, edges, os.path.join(d, "dag.gml"))
    return dict(AUTOTUNE_EXPECTED)


def write_fixture_trace(trace_dir: str) -> Dict[str, object]:
    """Materialize the fixture (comm.json + clock_sync.json +
    tensor_shapes/dtypes + gradient manifest + dag.gml + metadata per
    rank) and return :data:`EXPECTED`."""
    events = {0: _events_rank0(), 1: _events_rank1()}
    offsets = {0: 0.0, 1: 25.0}
    for rank in (0, 1):
        d = os.path.join(trace_dir, str(rank))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "comm.json"), "w") as f:
            json.dump(events[rank], f, indent=1)
        with open(os.path.join(d, "clock_sync.json"), "w") as f:
            json.dump({"offset_us": offsets[rank], "rtt_us": 8.0,
                       "samples": 8, "rank": rank,
                       "method": "fixture"}, f, indent=1)
        with open(os.path.join(d, "tensor_shapes.json"), "w") as f:
            json.dump({TENSOR: SHAPE}, f, indent=1)
        with open(os.path.join(d, "tensor_dtypes.json"), "w") as f:
            json.dump({TENSOR: "float32"}, f, indent=1)
        with open(os.path.join(d, "gradient_name_list.json"), "w") as f:
            json.dump([TENSOR], f, indent=1)
        with open(os.path.join(d, "metadata.json"), "w") as f:
            json.dump({"rank": rank, "size": 2, "model": "fixture"},
                      f, indent=1)
        nodes, edges = structure_dag([TENSOR])
        write_gml(nodes, edges, os.path.join(d, "dag.gml"))
    return dict(EXPECTED)
