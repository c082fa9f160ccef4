"""horovod_tpu_torch.timeline.profiler against
horovod_tpu.timeline.profiler.

* The parser and the cross-rank reduction: ``reduce_trace_events``,
  ``roofline_verdict`` and ``aggregate_anatomies`` give the reference's
  results, ``PROFILE_EXPECTED`` included, on its fixture corpus and on
  edge cases (empty capture, unmatched B/E, unknown segments, gaps under
  the threshold, no step envelope).
* The reference's ``load_compute_json`` / ``report_from_dir`` read the
  ``compute.json`` of a profiled port window.
* ``make_train_step(profile=True)`` on the CPU: the window's four
  segments once a profiled step each (``in_graph_steps`` looped), their
  FLOPs from FlopCounterMode (K1 counted by its op's formula); the
  profiled window gives the unprofiled step's losses and parameters in
  float64, bit for bit (``tests/test_torch_training.py``'s float64
  parity limits are 1e-6); after the window the step resumes from the
  updated state; ``HVD_PROFILE_XLA=1`` writes the torch.profiler trace
  with one range per gradient bucket; a finalized window's anatomy is
  pushed to the rendezvous server's ``profile`` scope.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu.timeline.profiler as ref
import horovod_tpu_torch.timeline.profiler as port
from horovod_tpu_torch import core, metrics, training
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.optim.fused_update import K1_FLOPS_PER_ELEMENT, fused_sgd

_FIXTURE_KW = dict(peak_flops=ref.PROFILE_PEAK_FLOPS,
                   hbm_bytes_per_sec=ref.PROFILE_HBM_BYTES_PER_SEC,
                   gap_threshold_us=ref.PROFILE_GAP_THRESHOLD_US)
#: the float64 parity limit of tests/test_torch_training.py
F64_TOL = 1e-6


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE", "HVD_TIMELINE", "HVD_TRACE_DIR",
              "HVD_PROFILE", "HVD_PROFILE_XLA", "HVD_TRACE_START_STEP",
              "HVD_TRACE_END_STEP", "HVD_PROFILE_START_STEP",
              "HVD_PROFILE_END_STEP", "HVD_METRICS_KV_ADDR",
              "HVD_METRICS_KV_PORT"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


@pytest.mark.parametrize("rank", [0, 1])
def test_fixture_anatomy_equals_the_references(rank):
    got = port.reduce_trace_events(port.profile_fixture_events(rank),
                                   **_FIXTURE_KW)
    want = ref.reduce_trace_events(ref.profile_fixture_events(rank),
                                   **_FIXTURE_KW)
    assert got == want
    exp = port.PROFILE_EXPECTED["ranks"][str(rank)]
    assert (got["steps"], got["mfu"], got["top_segment"]) == \
        (exp["steps"], exp["mfu"], exp["top_segment"])
    assert port.PROFILE_EXPECTED == ref.PROFILE_EXPECTED


EDGE_CASES = {
    "empty": [],
    "unmatched": [
        {"name": "STEP", "ph": "X", "ts": 0.0, "dur": 100.0},
        {"name": "fwd", "ph": "B", "ts": 0.0, "tid": "c"},
        {"name": "fwd", "ph": "B", "ts": 10.0, "tid": "c"},
        {"name": "fwd", "ph": "E", "ts": 40.0, "tid": "c"},
        {"name": "bwd", "ph": "E", "ts": 50.0, "tid": "c"},
        {"name": "opt", "ph": "B", "ts": 60.0, "tid": "c"}],
    "unknown_segment": [
        {"name": "STEP", "ph": "X", "ts": 0.0, "dur": 100.0},
        {"name": "mystery", "ph": "X", "ts": 0.0, "dur": 80.0}],
    "gap_under_threshold": [
        {"name": "STEP", "ph": "X", "ts": 0.0, "dur": 100.0},
        {"name": "a", "ph": "X", "ts": 0.0, "dur": 50.0},
        {"name": "b", "ph": "X", "ts": 60.0, "dur": 40.0,
         "args": {"flops": 3e6, "bytes": 1e3}}],
    "no_step_envelope": [
        {"name": "a", "ph": "X", "ts": 100.0, "dur": 50.0},
        {"name": "b", "ph": "X", "ts": 150.0, "dur": 50.0}],
    "host_bound": [
        {"name": "STEP", "ph": "X", "ts": 0.0, "dur": 100.0},
        {"name": "a", "ph": "X", "ts": 40.0, "dur": 10.0,
         "args": {"bytes": 1e6}}],
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_parser_edge_cases_equal_the_references(case):
    evs = EDGE_CASES[case]
    assert port.reduce_trace_events(evs, **_FIXTURE_KW) == \
        ref.reduce_trace_events(evs, **_FIXTURE_KW)


@pytest.mark.parametrize("flops,nbytes,us", [
    (None, None, 100.0), (1e9, None, 100.0), (None, 1e6, 100.0),
    (250e6, 1e6, 100.0), (100e6, 1e6, 100.0), (2e9, 1e6, 100.0),
    (1e9, 1e6, 0.0), (5.0, 0.0, 3.0)])
def test_roofline_verdict_equals_the_references(flops, nbytes, us):
    kw = dict(peak_flops=200e12, hbm_bytes_per_sec=800e9)
    assert port.roofline_verdict(flops, nbytes, us, **kw) == \
        ref.roofline_verdict(flops, nbytes, us, **kw)


def test_aggregate_and_report_equal_the_references(tmp_path):
    port.write_profile_fixture(str(tmp_path))
    got, want = port.report_from_dir(str(tmp_path)), \
        ref.report_from_dir(str(tmp_path))
    assert got == want
    assert got["aggregate"]["segments"]["backward"]["slowest_rank"] == "1"
    bad = {"0": {"segments": {"a": {"device_us": 5}}, "mfu": 0.2,
                 "host_gap": {}}, "1": "<undecodable>"}
    assert port.aggregate_anatomies(bad) == ref.aggregate_anatomies(bad)
    with pytest.raises(FileNotFoundError):
        port.report_from_dir(str(tmp_path / "none"))


def _mlp(dtype=torch.float32):
    torch.manual_seed(0)
    model = MLP(12, (16, 6)).to(dtype)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(8, 12, generator=gen, dtype=dtype)
    y = torch.randint(0, 6, (8,), generator=gen)
    return model, x, y


def _run(steps, *, profile, k=1, dtype=torch.float32):
    model, x, y = _mlp(dtype)
    opt = fused_sgd(0.1, momentum=0.9)
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt, loss_fetch_steps=0,
                                    profile=profile, in_graph_steps=k)
    state = training.init_train_state(model, opt)
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, y)
        losses.append(loss.item())
    return step, state, np.asarray(losses)


def _profile_env(monkeypatch, trace_dir, start=2, end=3):
    monkeypatch.setenv("HVD_TRACE_DIR", str(trace_dir))
    monkeypatch.setenv("HVD_PROFILE_START_STEP", str(start))
    monkeypatch.setenv("HVD_PROFILE_END_STEP", str(end))


@pytest.mark.parametrize("k", [1, 2])
def test_profiled_window_writes_the_four_segments(port_cpu_world, tmp_path,
                                                  monkeypatch, k):
    _profile_env(monkeypatch, tmp_path)
    step, state, losses = _run(5, profile=True, k=k)
    assert step.profiler is not None and np.isfinite(losses).all()
    assert step.calls == {"eager": 3, "capture": 0, "replay": 0}
    art = json.loads((tmp_path / "0" / "compute.json").read_text())
    assert art["rank"] == 0 and art["clock"] == "local"
    an = art["anatomy"]
    segs = an["segments"]
    assert sorted(segs) == ["backward", "forward", "grad_allreduce",
                            "optimizer_update"]
    assert an["steps"] == 2 and all(s["count"] == 2 * k
                                    for s in segs.values())
    # FLOPs of a segment's first run: the forward's two matrix products,
    # the backward's forward again and its two gradients each, K1's rule
    n = 12 * 16 + 16 * 6
    assert segs["forward"]["flops"] == 2 * k * 2 * 8 * n
    assert segs["backward"]["flops"] == 2 * k * (2 * 8 * n * 2 +
                                                 2 * 8 * 16 * 6)
    assert segs["optimizer_update"]["flops"] == \
        2 * k * K1_FLOPS_PER_ELEMENT["momentum"] * (n + 16 + 6)
    assert all(s["bytes"] > 0 for s in segs.values())
    assert step.profile_losses == list(losses[1:3])
    assert metrics.TRAIN_LOSS.get() == losses[2]
    assert metrics.STEP_PHASE_FRACTION.get("forward") == \
        segs["forward"]["fraction"]


def test_profiled_window_equals_the_unprofiled_steps_float64(
        port_cpu_world, tmp_path, monkeypatch):
    _, plain, want = _run(6, profile=False, dtype=torch.float64)
    _profile_env(monkeypatch, tmp_path, start=2, end=4)
    step, prof, got = _run(6, profile=True, dtype=torch.float64)
    assert step.profiler.anatomy["steps"] == 3
    # steps 5 and 6 run the compiled step again, from the window's state
    np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=0)
    assert prof.step == plain.step == 6
    for k in plain.params:
        np.testing.assert_allclose(prof.params[k].detach().numpy(),
                                   plain.params[k].detach().numpy(),
                                   rtol=F64_TOL,
                                   atol=F64_TOL, err_msg=k)
    assert np.array_equal(got, want)          # the same math, bit for bit
    assert int(prof.opt_state.count) == 6


def test_the_reference_reads_a_port_compute_json(port_cpu_world, tmp_path,
                                                 monkeypatch):
    _profile_env(monkeypatch, tmp_path)
    _run(4, profile=True)
    per_rank = ref.load_compute_json(str(tmp_path))
    assert list(per_rank) == [0]
    report = ref.report_from_dir(str(tmp_path))
    assert report == port.report_from_dir(str(tmp_path))
    assert sorted(report["aggregate"]["top_segments"]) == [
        "backward", "forward", "grad_allreduce", "optimizer_update"]
    assert ref.own_rank_anatomy(str(tmp_path), rank=0) == \
        port.own_rank_anatomy(str(tmp_path)) == per_rank[0]["anatomy"]
    events = per_rank[0]["events"]
    assert {e["name"] for e in events} == {
        "STEP", "forward", "backward", "grad_allreduce", "optimizer_update"}


def test_the_cuda_trace_holds_a_range_per_bucket(port_cpu_world, tmp_path,
                                                 monkeypatch):
    _profile_env(monkeypatch, tmp_path, start=1, end=2)
    monkeypatch.setenv("HVD_PROFILE_XLA", "1")
    monkeypatch.setenv("HVD_FUSION_THRESHOLD", "512")
    step, state, _ = _run(3, profile=True)
    from horovod_tpu_torch.ops.fusion import FusionPlan

    buckets = FusionPlan(list(state.params.values()), 512).num_buckets()
    trace = json.loads((tmp_path / "0" / port.CUDA_TRACE_DIR / "trace.json")
                       .read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ranges = sorted(e["name"] for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("allreduce:"))
    # each bucket under 512 bytes, in the segments' first run and in the
    # window's 2 calls
    assert buckets > 1
    assert len(ranges) == buckets * 3 and len(set(ranges)) == buckets
    assert all(name in "".join(ranges) for name in (
        "Dense_0/kernel", "Dense_1/kernel", "Dense_0/bias", "Dense_1/bias"))


def test_profile_needs_somewhere_to_write(port_cpu_world, monkeypatch):
    step, _, losses = _run(2, profile=True)
    assert step.profiler is None and np.isfinite(losses).all()
    monkeypatch.setenv("HVD_PROFILE", "0")
    assert port.from_env() is None


def test_finalize_deferred_while_step_in_flight(tmp_path):
    prof = port.ComputeProfiler(trace_dir=str(tmp_path), rank=0,
                                enabled=True, start_step=1, end_step=1)
    assert prof.on_step()
    with prof.step_span():
        prof.run_segment("forward", lambda: None)
        prof.finalize()
        assert prof.anatomy is None
        prof.run_segment("backward", lambda: None)
    assert prof.anatomy is not None
    art = json.loads((tmp_path / "0" / "compute.json").read_text())
    assert set(art["anatomy"]["segments"]) == {"forward", "backward"}


def test_a_window_opening_as_the_timeline_closes_is_finalized_empty(
        tmp_path, monkeypatch):
    """Both packages: a profiler whose window opens on the call after the
    timeline's end step is finalized by the timeline's shutdown in that
    same call (``finalize_active``), before its first segment, and
    captures nothing (why the launcher phase of ``chip_smoke.py`` opens
    the profiler's window a few calls after the timeline has closed)."""
    import importlib

    monkeypatch.setenv("HVD_TRACE_START_STEP", "1")
    monkeypatch.setenv("HVD_TRACE_END_STEP", "1")
    for side in ("horovod_tpu_torch", "horovod_tpu"):
        tl_mod = importlib.import_module(f"{side}.timeline.timeline")
        prof_mod = importlib.import_module(f"{side}.timeline.profiler")
        tl = tl_mod.Timeline()
        monkeypatch.setattr(tl_mod, "timeline", tl)
        tl.initialize(str(tmp_path / side))
        prof = prof_mod.ComputeProfiler(trace_dir=str(tmp_path / side),
                                        rank=0, enabled=True, start_step=2,
                                        end_step=3)
        opened = []
        for _ in range(3):
            opened.append(prof.on_step())   # the step wrapper's order
            tl.record_step(owner="train_step")
        tl.shutdown()
        assert opened == [False, True, False], side
        assert prof.anatomy is None or prof.anatomy["steps"] == 0, side


def test_the_summary_push_raises_with_a_rendezvous(tmp_path, monkeypatch):
    """Named for what it held before the rendezvous plane was ported (the
    push raised); now finalizing a window pushes the anatomy to the
    server's ``profile`` scope under the profiler's rank."""
    from torch_rdv import kv_env, serving

    prof = port.ComputeProfiler(trace_dir=str(tmp_path), rank=2,
                                enabled=True, start_step=1, end_step=1)
    assert prof.on_step()
    with prof.step_span():
        prof.run_segment("forward", lambda: torch.ones(2))
    with serving("reference") as srv:
        kv_env(monkeypatch, srv)
        prof.finalize()
        report = srv.profile_report()
    assert (tmp_path / "2" / "compute.json").exists()
    assert report["ranks"] == {"2": prof.anatomy}
    assert report["aggregate"]["ranks"] == ["2"]
