"""horovod_tpu_torch.timeline against horovod_tpu.timeline: the same
calls on the reference's ``Timeline`` and the port's give the same
events (timestamps left out) — the per-rank layout, the step window,
owner dedupe, the auto-close at the end step and a fresh window after
it, ``arm``, ``CYCLE_START`` — with each package's native writer
(``csrc/timeline.cc``, built with g++) and the port's Python writer;
the port's two writers write the same events; ``metrics.json`` lands
next to ``comm.json``, and ``clock_sync.json`` too when the rendezvous
server is named; and a 2-rank gloo job's per-rank ``comm.json``
is read unchanged by the reference's ``merge_traces`` and
``straggler_report``."""

import json

import pytest

from horovod_tpu.timeline import merge as ref_merge
from horovod_tpu.timeline.timeline import Timeline as RefTimeline
from horovod_tpu_torch.timeline.timeline import Timeline as PortTimeline
from torch_dist_worker import launch


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for k in ("HVD_TIMELINE", "HVD_TRACE_DIR", "HVD_TRACE_START_STEP",
              "HVD_TRACE_END_STEP", "HVD_TIMELINE_MARK_CYCLES",
              "HVD_TIMELINE_PYTHON", "HVD_METRICS_KV_ADDR",
              "HVD_METRICS_KV_PORT"):
        monkeypatch.delenv(k, raising=False)


def _read(path):
    with open(path) as f:
        return json.load(f)


def _events(path):
    """The events without their clock: ts and dur left out, ``cat``
    read as the native writer writes a missing one ("")."""
    return [{**{k: v for k, v in e.items() if k not in ("ts", "dur")},
             "cat": e.get("cat", "")} for e in _read(path)]


def scenario_layout(make, root, monkeypatch):
    tl = make()
    tl.initialize(str(root))
    with tl.span("allreduce.grad0", "ALLREDUCE"):
        pass
    tl.negotiate_start("allreduce.grad0", "ALLREDUCE")
    tl.negotiate_rank_ready("allreduce.grad0", 3)
    tl.negotiate_end("allreduce.grad0", "ALLREDUCE")
    with tl.span("w", "MESH_ALLREDUCE", rank=5):
        pass
    tl.shutdown()
    return [root / "0" / "comm.json"]


def scenario_window(make, root, monkeypatch):
    monkeypatch.setenv("HVD_TRACE_START_STEP", "2")
    monkeypatch.setenv("HVD_TRACE_END_STEP", "3")
    tl = make()
    tl.initialize(str(root))
    steps = []
    for step in range(1, 6):
        steps.append(tl.record_step())
        with tl.span(f"step{step}", "ALLREDUCE"):
            pass
    assert steps == [1, 2, 3, 4, 5] and not tl.active
    tl.shutdown()
    return [root / "0" / "comm.json"]


def scenario_owner_dedupe(make, root, monkeypatch):
    tl = make()
    tl.initialize(str(root))
    for real_step in range(1, 4):
        assert tl.record_step(owner="timeline_hook") == real_step
        assert tl.record_step(owner="train_step") == real_step
        with tl.span("train_step", "STEP"):
            pass
    assert tl._step == 3
    tl.shutdown()
    return [root / "0" / "comm.json"]


def scenario_autoclose_reinit(make, root, monkeypatch):
    monkeypatch.setenv("HVD_TRACE_END_STEP", "1")
    tl = make()
    tl.initialize(str(root / "first"))
    tl.record_step()
    with tl.span("s1", "ALLREDUCE"):
        pass
    tl.record_step()
    assert not tl.active
    monkeypatch.setenv("HVD_TRACE_END_STEP", "2")
    tl.initialize(str(root / "second"))
    assert tl.active
    assert tl.record_step(owner="train_step") == 1
    with tl.span("s2", "ALLREDUCE"):
        pass
    tl.shutdown()
    return [root / "first" / "0" / "comm.json",
            root / "second" / "0" / "comm.json"]


def scenario_arm(make, root, monkeypatch):
    monkeypatch.setenv("HVD_TRACE_START_STEP", "1000")
    tl = make()
    tl.initialize(str(root))
    for _ in range(3):
        tl.record_step()
    assert tl.arm(10, 11, current_step=8)
    for step in range(9, 14):
        tl.record_step()
        with tl.span(f"step{step}", "ALLREDUCE"):
            pass
    tl.shutdown()
    return [root / "0" / "comm.json"]


def scenario_cycles(make, root, monkeypatch):
    monkeypatch.setenv("HVD_TIMELINE_MARK_CYCLES", "1")
    tl = make()
    tl.initialize(str(root))
    for _ in range(2):
        tl.record_step()
        tl.mark_cycle_start()
        with tl.span("train_step", "STEP"):
            pass
    tl.shutdown()
    return [root / "0" / "comm.json"]


SCENARIOS = {"layout": scenario_layout, "window": scenario_window,
             "owner_dedupe": scenario_owner_dedupe,
             "autoclose_reinit": scenario_autoclose_reinit,
             "arm": scenario_arm, "cycles": scenario_cycles}


@pytest.mark.parametrize("python_writer", [False, True],
                         ids=["native", "python"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_calls_give_the_references_events(tmp_path, monkeypatch, name,
                                               python_writer):
    scenario = SCENARIOS[name]
    want = [_events(p) for p in scenario(RefTimeline, tmp_path / "ref",
                                         monkeypatch)]
    monkeypatch.delenv("HVD_TRACE_START_STEP", raising=False)
    monkeypatch.delenv("HVD_TRACE_END_STEP", raising=False)
    if python_writer:
        monkeypatch.setenv("HVD_TIMELINE_PYTHON", "1")
    got = [_events(p) for p in scenario(PortTimeline, tmp_path / "port",
                                        monkeypatch)]
    assert got == want
    assert any(want)


def test_native_and_python_writers_write_the_same_events(tmp_path,
                                                         monkeypatch):
    kinds = {}
    out = {}
    for kind in ("native", "python"):
        if kind == "python":
            monkeypatch.setenv("HVD_TIMELINE_PYTHON", "1")
        tl = PortTimeline()
        tl.initialize(str(tmp_path / kind))
        kinds[kind] = tl.writer_kind
        for i in range(3):
            tl.record_step()
            tl.negotiate_start(f"t{i}", "ALLREDUCE")
            tl.negotiate_end(f"t{i}", "ALLREDUCE")
            t0 = tl.begin()
            with tl.span(f"t{i}", "MESH_ALLREDUCE"):
                pass
            tl.end(f"t{i}", "MESH_ALLREDUCE", t0)
        tl.shutdown()
        assert tl.writer_kind is None
        raw = _read(tmp_path / kind / "0" / "comm.json")
        assert all(isinstance(e["ts"], float) for e in raw)
        out[kind] = _events(tmp_path / kind / "0" / "comm.json")
    assert kinds == {"native": "native", "python": "python"}
    assert out["native"] == out["python"]
    assert len(out["native"]) == 3 * 4


def test_metrics_json_lands_next_to_comm_json(tmp_path):
    from horovod_tpu_torch import metrics

    tl = PortTimeline()
    tl.initialize(str(tmp_path))
    metrics.JOIN_EVENTS.inc()
    tl.shutdown()
    snap = _read(tmp_path / "0" / "metrics.json")
    assert snap["metrics"]["hvd_join_events_total"]["samples"]
    assert (tmp_path / "0" / "comm.json").exists()


def test_disabled_without_a_directory():
    tl = PortTimeline()
    tl.initialize(None)
    assert not tl.enabled and tl.writer_kind is None
    with tl.span("x", "ALLREDUCE"):
        pass
    assert tl.begin() is None
    tl.end("x", "ALLREDUCE", None)
    assert not tl.arm(1, 2)


def test_the_clock_handshake_raises_with_a_rendezvous(tmp_path,
                                                      monkeypatch):
    """Named for what it held before the rendezvous plane was ported (the
    handshake raised); now opening a trace with the server's address
    writes ``clock_sync.json`` beside ``comm.json``, with the reference's
    keys, and ``HVD_REPLAY_CLOCK_SYNC=0`` skips it."""
    from torch_rdv import kv_env, serving

    with serving("port") as srv:
        kv_env(monkeypatch, srv)
        for tl, d in ((PortTimeline(), tmp_path), (RefTimeline(),
                                                   tmp_path / "ref")):
            tl.initialize(str(d))
            tl.shutdown()
        sync, want = (json.loads((d / "0" / "clock_sync.json").read_text())
                      for d in (tmp_path, tmp_path / "ref"))
        assert sorted(sync) == sorted(want)
        assert sync["rtt_us"] >= 0 and sync["rank"] == 0
        assert sync["method"] == want["method"]
        monkeypatch.setenv("HVD_REPLAY_CLOCK_SYNC", "0")
        tl.initialize(str(tmp_path / "b"))
        assert tl.active
        tl.shutdown()
        assert not (tmp_path / "b" / "0" / "clock_sync.json").exists()


def test_the_gpt_bench_traces_the_window_calls(tmp_path, monkeypatch):
    """``gpt_synthetic_benchmark --cuda-trace`` (``window_traced``): one
    torch.profiler capture from the window's first call to its last,
    written to ``<rank dir>/cuda_trace/trace.json``."""
    import importlib

    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    tl_mod = importlib.import_module("horovod_tpu_torch.timeline.timeline")

    monkeypatch.setenv("HVD_TRACE_START_STEP", "2")
    monkeypatch.setenv("HVD_TRACE_END_STEP", "3")
    tl = PortTimeline()
    monkeypatch.setattr(tl_mod, "timeline", tl)
    tl.initialize(str(tmp_path))
    started = []

    def step(state, x, y):
        started.append(tl.steps + 1)
        tl.record_step(owner="train_step")
        return state, x

    traced = gb.window_traced(step)
    for i in range(4):
        traced(None, i, None)
        want = (tmp_path / "0" / "cuda_trace" / "trace.json").exists()
        assert want == (i >= 2), i     # written after call 3
    tl.shutdown()
    assert started == [1, 2, 3, 4]


def test_two_rank_comm_json_read_by_the_references_merge(tmp_path):
    launch("trace", 2, tmp_path)
    trace_dir = str(tmp_path / "trace")
    assert sorted(ref_merge.discover_ranks(trace_dir)) == [0, 1]
    merged = ref_merge.merge_traces(trace_dir)
    events = merged["traceEvents"] if isinstance(merged, dict) else merged
    spans = [e for e in events if e.get("ph") != "M"]
    assert {e["pid"] for e in spans} == {0, 1}
    # per rank: two allreduces and an allgather negotiated (B and E),
    # their mesh spans and the frontend's two
    for rank in (0, 1):
        mine = [e for e in spans if e["pid"] == rank]
        assert sum(e["name"].startswith("NEGOTIATE_") for e in mine) == 6
        assert sorted(e["tid"] for e in mine
                      if e["name"] == "MESH_ALLREDUCE") == \
            ["allreduce.w", "allreduce.w", "grad.a", "grad.b"]
        assert [e["tid"] for e in mine
                if e["name"] == "MESH_ALLGATHER"] == ["rows"]
    report = ref_merge.straggler_report(trace_dir)
    tensors = report["tensors"] if "tensors" in report else report
    assert {"grad.a", "grad.b", "rows"} <= set(
        t if isinstance(t, str) else t.get("tensor") for t in tensors)
    for rank in (0, 1):
        snap = _read(tmp_path / "trace" / str(rank) / "metrics.json")
        assert snap["metrics"]["hvd_host_collective_calls_total"][
            "samples"]
