"""The port's trace analysis against the reference's: the cross-rank
merge, the stitcher, the critical path, the what-if simulator, the
hand-computed fixtures, the projection and the clock handshake
(``horovod_tpu_torch.timeline.merge`` / ``.replay``).

* On the reference's 2-rank fixture trace, the port's ``analyze`` gives
  the reference's summary (critical path, attribution, ranked what-ifs,
  per-tensor cost table) with the same explicit cost model, and both
  recover ``EXPECTED`` and ``AUTOTUNE_EXPECTED``; the port's fixture
  writer writes a trace both read the same way.
* On a 2-rank gloo trace the port itself wrote (``torch_dist_worker``
  task ``replay``: the eager drive of the trace tests with the timeline
  on), ``merge_traces``, ``straggler_report`` and ``analyze`` give the
  same results through the port and through the reference.
* The projection matches the reference's on the fixture at 64x and at a
  two-level topology, given the same explicit spec; the port's own
  hand-computed ``PROJECTION_EXPECTED`` holds under its H100 defaults.
* The clock handshake takes an injected server clock and equals the
  reference's fed the same clocks; without one it raises
  ``NotImplementedError`` (no rendezvous server yet).
* ``live_trace`` (``make_train_step(donate=False)``) writes a trace
  ``live_validation`` projects: its numbers are host timings, so only
  their shape is checked.
"""

import json
import math
import os

import numpy as np
import pytest

from horovod_tpu.timeline import merge as ref_merge
from horovod_tpu.timeline import replay as ref_replay
from horovod_tpu.timeline.replay import fixture as ref_fixture
from horovod_tpu.timeline.replay import projection as ref_projection
from horovod_tpu.optim import profile_guided as ref_pg
from horovod_tpu_torch.optim import profile_guided as pg
from horovod_tpu_torch.timeline import merge, replay
from horovod_tpu_torch.timeline.comm_report import TopologySpec
from horovod_tpu_torch.timeline.replay import clock, fixture, projection
from horovod_tpu_torch.timeline.replay.simulator import (
    CostModel, bucket_plan_search, identify_straggler,
)
from torch_dist_worker import launch

#: explicit α–β values both sides price with
CM = {"world": 2, "ici_bytes_per_sec": 120e9, "hop_latency_us": 1.5,
      "local_size": 1, "dcn_bytes_per_sec": 20e9, "dcn_hop_latency_us": 8.0}


def _cms(**kw):
    args = dict(CM, **kw)
    return CostModel(**args), ref_replay.CostModel(**args)


def _no_dir(summary):
    return {k: v for k, v in summary.items() if k != "trace_dir"}


@pytest.fixture()
def fixture_dirs(tmp_path):
    """The fixture written by each package's writer."""
    dirs = {}
    for name, mod in (("port", fixture), ("ref", ref_fixture)):
        d = str(tmp_path / name)
        mod.write_fixture_trace(d)
        dirs[name] = d
    return dirs


def test_fixture_writers_write_the_same_trace(fixture_dirs):
    for rank in ("0", "1"):
        for name in ("comm.json", "clock_sync.json", "tensor_shapes.json",
                     "tensor_dtypes.json", "gradient_name_list.json",
                     "metadata.json"):
            with open(os.path.join(fixture_dirs["port"], rank, name)) as a, \
                    open(os.path.join(fixture_dirs["ref"], rank, name)) as b:
                assert json.load(a) == json.load(b), name


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_fixture_analyze_matches_reference(fixture_dirs, writer):
    d = fixture_dirs[writer]
    cm, rcm = _cms()
    got = replay.analyze(d, cost_model=cm).summary
    want = ref_replay.analyze(d, cost_model=rcm).summary
    assert got == want
    step = got["steps"][0]
    exp = fixture.EXPECTED
    assert step["replay_step_us"] == exp["makespan_us"]
    assert [{k: row[k] for k in e} for row, e in zip(
        step["critical_path"], exp["critical_path"])] == \
        exp["critical_path"]
    for rank, a in exp["attribution"].items():
        for key, v in a.items():
            assert step["attribution"]["per_rank"][rank][key] == \
                pytest.approx(v)
    scen = {s["scenario"]: s for s in step["what_if"]["scenarios"]}
    assert scen[f"remove_straggler_rank_{exp['straggler_rank']}"][
        "predicted_step_us"] == pytest.approx(exp["remove_straggler_us"])
    assert got["clock_aligned"] is True


def test_stitcher_and_straggler_match_reference(fixture_dirs):
    d = fixture_dirs["port"]
    art, dags = replay.stitch(d)
    rart, rdags = ref_replay.stitch(d)
    assert [vars(n) for n in dags[0].nodes] == \
        [vars(n) for n in rdags[0].nodes]
    assert dags[0].chains == rdags[0].chains
    assert dags[0].measured_step_us == rdags[0].measured_step_us
    sched = replay.schedule(dags[0])
    assert identify_straggler(dags[0], sched) == \
        ref_replay.identify_straggler(rdags[0], ref_replay.schedule(
            rdags[0])) == fixture.EXPECTED["straggler_rank"]
    assert sched.makespan == fixture.EXPECTED["makespan_us"]
    assert art.gradient_names == rart.gradient_names


@pytest.fixture()
def autotune_dir(tmp_path):
    fixture.write_autotune_fixture_trace(str(tmp_path))
    return str(tmp_path)


def test_autotune_fixture_is_recovered_exactly(autotune_dir):
    exp = fixture.AUTOTUNE_EXPECTED
    assert exp == ref_fixture.AUTOTUNE_EXPECTED
    cm, rcm = _cms(hop_latency_us=exp["hop_latency_us"])
    summary = replay.analyze(autotune_dir, cost_model=cm).summary
    assert summary == ref_replay.analyze(autotune_dir,
                                         cost_model=rcm).summary
    wi = summary["steps"][0]["what_if"]
    assert wi["baseline_replay_us"] == exp["baseline_us"]
    by = {s["scenario"]: s for s in wi["scenarios"]}
    assert by["fuse_buckets_2"]["predicted_step_us"] == \
        exp["uncompressed_step_us"]
    cc = by["fuse_buckets_2_compressed"]
    assert cc["predicted_step_us"] == exp["predicted_step_us"]
    assert cc["plan"]["buckets"] == exp["optimal_buckets"]
    assert cc["plan"]["compression"] == exp["optimal_compression"]
    assert by["compress_int8"]["predicted_step_us"] == \
        exp["compress_int8_us"]
    assert by["fuse_all_comm"]["predicted_step_us"] == exp["fuse_all_us"]
    assert by["overlap_comm"]["predicted_step_us"] == exp["overlap_us"]
    searched = {r["num_buckets"]: r["predicted_step_us"] for r in
                bucket_plan_search(replay.stitch(autotune_dir)[1][0], cm)}
    assert searched == exp["bucket_search_us"]
    plan = pg.plan_from_trace(autotune_dir, cost_model=cm)
    want = ref_pg.plan_from_trace(autotune_dir, cost_model=rcm)
    assert plan.to_dict() == want.to_dict()
    assert plan.buckets == exp["optimal_buckets"]
    assert plan.compression == exp["optimal_compression"]
    assert plan.predicted_speedup_pct == exp["predicted_speedup_pct"]


# ---------------------------------------------------------------------------
# the port's own trace
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """The trace and live-projection dirs of a 2-rank gloo job."""
    work = tmp_path_factory.mktemp("replay")
    rcs, outs = launch("replay", 2, work)
    assert rcs == [0, 0], "\n".join(outs)
    return work


def test_port_trace_merges_as_the_reference_merges(port_trace):
    d = str(port_trace / "trace")
    got, want = merge.merge_traces(d), ref_merge.merge_traces(d)
    assert got == want
    assert {e["pid"] for e in got["traceEvents"]} == {0, 1}
    assert any(e.get("name") == "MESH_ALLREDUCE"
               for e in got["traceEvents"])
    assert merge.straggler_report(d) == ref_merge.straggler_report(d)
    assert merge.straggler_report(d)["tensors"]


def test_port_trace_replays_as_the_reference_replays(port_trace):
    d = str(port_trace / "trace")
    cm, rcm = _cms()
    got = replay.analyze(d, cost_model=cm).summary
    assert got == ref_replay.analyze(d, cost_model=rcm).summary
    assert got["ranks"] == [0, 1] and got["clock_aligned"] is False
    assert replay.analyze(d, cost_model=cm, last_steps=1).summary == \
        ref_replay.analyze(d, cost_model=rcm, last_steps=1).summary


def test_live_projection_of_the_port_step(port_trace, tmp_path,
                                          monkeypatch):
    """A 1-rank live trace in this process projected onto the 2-rank
    one the job wrote: the validation record, finite (host timings)."""
    import horovod_tpu_torch as htt

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    htt.shutdown()
    htt.init(device="cpu")
    try:
        src = projection.live_trace(str(tmp_path / "src"), steps=3,
                                    global_batch=16, in_dim=8, classes=4,
                                    width=16)
    finally:
        htt.shutdown()
    rec = projection.live_validation(src, str(port_trace / "live"),
                                     steps=3, global_batch=16)
    assert rec["source_world"] == 1 and rec["target_world"] == 2
    assert math.isfinite(rec["err_pct"])
    assert rec["projected_step_us"] > 0 and rec["measured_step_us"] > 0
    with open(os.path.join(src, "0", "tensor_shapes.json")) as f:
        assert json.load(f) == {"g0": [16], "g1": [16, 8], "g2": [4],
                                "g3": [4, 16]}


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", [
    "64x",
    "world=6,local=2,two_level=on",
    "2x..16x",
    "world=16,local=4,compression=int8,two_level=auto",
])
@pytest.mark.parametrize("mode", ["distribution", "slowest"])
def test_projection_matches_reference(fixture_dirs, text, mode):
    d = fixture_dirs["port"]
    spec = dict(world=2, ici_bytes_per_sec=120e9, ici_hop_latency_us=1.5,
                dcn_bytes_per_sec=20e9, dcn_hop_latency_us=8.0,
                two_level="auto")
    base, rbase = TopologySpec(**spec), ref_replay.TopologySpec(**spec)
    res = replay.analyze(d, plan_search=False)
    rres = ref_replay.analyze(d, plan_search=False)
    got = projection.project_analysis(
        res, projection.parse_project_spec(text, 2, base), mode=mode,
        cost_model=CostModel.from_topology(base))
    want = ref_projection.project_analysis(
        rres, ref_projection.parse_project_spec(text, 2, rbase), mode=mode,
        cost_model=ref_replay.CostModel.from_topology(rbase))
    assert _no_dir(got) == _no_dir(want)


def test_projection_expected_under_the_h100_defaults(fixture_dirs):
    exp = fixture.PROJECTION_EXPECTED
    base = TopologySpec(world=2, two_level="auto")
    cm = CostModel.from_topology(base)
    res = replay.analyze(fixture_dirs["port"], plan_search=False)
    rows = {}
    for text in ("1x", "2x", "world=6,local=2,two_level=on"):
        rows[text] = projection.project_analysis(
            res, projection.parse_project_spec(text, 2, base),
            mode="distribution", cost_model=cm)["projections"][0]
    assert rows["1x"]["projected_step_us"] == exp["identity_us"]
    assert rows["2x"]["projected_step_us"] == exp["world4_us"]
    assert rows["2x"]["scaling_efficiency"] == exp["world4_efficiency"]
    assert rows["world=6,local=2,two_level=on"]["projected_step_us"] == \
        exp["world6_local2_us"]
    (_, spec), = projection.parse_project_spec("2x", 2, base)
    pdag, _ = projection.project_dag(res.dags[0], cm, spec,
                                     mode="distribution")
    comm, = [n for n in pdag.nodes if n.kind == "comm"]
    assert comm.dur_us == pytest.approx(exp["world4_comm_us"], rel=1e-12)
    assert cm.hop_latency_us == exp["hop_latency_us"]


def test_project_serving_p99_matches_reference():
    for args in ((10.0, 40.0, 4, 1), (None, 40.0, 2, -1), (5.0, None, 3, 1),
                 (5.0, 9.0, 1, -1)):
        assert projection.project_serving_p99(*args) == \
            ref_projection.project_serving_p99(*args)
    stats = {"p50_ms": 12.0, "p99_ms": 80.0}
    assert projection.serving_slo_headroom(stats, 3, 70.0, -1) == \
        ref_projection.serving_slo_headroom(stats, 3, 70.0, -1)


# ---------------------------------------------------------------------------
# the clock handshake
# ---------------------------------------------------------------------------
def _scripted(values):
    it = iter(values)
    return lambda: next(it)


def test_clock_handshake_matches_reference(monkeypatch):
    import horovod_tpu.run.http_client as ref_http

    server = [1000.0, 2000.0, 3050.0, 4000.0]
    local = [10.0, 30.0, 100.0, 105.0, 200.0, 260.0, 300.0, 340.0]
    monkeypatch.setattr(ref_http, "get_clock",
                        lambda *a, **k: next(srv_ref))
    srv_ref = iter(server)
    want = ref_replay.estimate_offset("h", 1, samples=4,
                                      local_clock_us=_scripted(local))
    got = clock.estimate_offset("h", 1, samples=4,
                                local_clock_us=_scripted(local),
                                server_clock_us=_scripted(server))
    assert got == want
    assert got["rtt_us"] == 5.0


@pytest.mark.parametrize("fn", ["sample_offset", "estimate_offset"])
def test_clock_handshake_without_a_server_clock_raises(fn):
    with pytest.raises(NotImplementedError, match="rendezvous server"):
        getattr(clock, fn)("localhost", 1)


def test_timeline_writes_no_clock_sidecar(port_trace):
    for rank in ("0", "1"):
        assert not (port_trace / "trace" / rank /
                    merge.CLOCK_SYNC_FILE).exists()


def test_trace_analysis_is_exported_lazily():
    import horovod_tpu_torch.timeline as tl

    assert tl.merge_traces is merge.merge_traces
    assert tl.analyze is replay.analyze
    assert tl.TopologySpec is TopologySpec
    assert tl.replay is replay and tl.comm_report.TopologySpec is \
        TopologySpec
    assert np.isclose(tl.predict_collective_us("all-reduce", 1 << 20, 2),
                      replay.CostModel(world=2).predict_us(
                          replay.stitcher.Node(0, "comm", 0.0,
                                               op="all-reduce",
                                               nbytes=1 << 20)))
