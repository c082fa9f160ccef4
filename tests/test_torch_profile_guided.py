"""horovod_tpu_torch.optim.profile_guided and .compute_knobs against the
reference's: the plan spec, the α–β warm start, the closed loop
(measure → plan → apply → verify / roll back) and the compute tier, and
the loop inside ``make_train_step(profile_guided=True)``.

* ``ProfileGuidedTuner`` is driven with scripted ``analyze`` / ``apply``
  callables and scripted step times (no host clock): its phase sequence
  and history — applied, verified, rolled back, retained, steady,
  frozen — equal the reference's.
* The compute tier recovers ``COMPUTE_AUTOTUNE_EXPECTED`` exactly, and
  its plans from an anatomy equal the reference's.
* In the train step (the tuner's clock scripted through
  ``training._clock``), the fused-optimizer plan is applied through the
  rebuild seam and verified, or rolled back, and the losses stay those
  of the untuned per-leaf run (the two paths are bit-identical at one
  rank on the CPU).
* A push target raises ``NotImplementedError`` until the rendezvous
  server is ported.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.optim import compute_knobs as ref_ck
from horovod_tpu.optim import profile_guided as ref
from horovod_tpu.timeline import replay as ref_replay
from horovod_tpu_torch import core, training
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.optim import compute_knobs as ck
from horovod_tpu_torch.optim import profile_guided as pg
from horovod_tpu_torch.optim.autotune import TunableParams
from horovod_tpu_torch.optim.fused_update import fused_sgd
from horovod_tpu_torch.timeline import replay
from horovod_tpu_torch.timeline.replay.fixture import (
    AUTOTUNE_EXPECTED, write_autotune_fixture_trace,
)

E = ck.COMPUTE_AUTOTUNE_EXPECTED


@pytest.fixture(scope="module")
def summaries(tmp_path_factory):
    """The autotune fixture's analyze() summary through each package."""
    d = str(tmp_path_factory.mktemp("pg"))
    write_autotune_fixture_trace(d)
    hop = AUTOTUNE_EXPECTED["hop_latency_us"]
    return (replay.analyze(d, cost_model=replay.CostModel(
        world=2, hop_latency_us=hop)).summary,
        ref_replay.analyze(d, cost_model=ref_replay.CostModel(
            world=2, hop_latency_us=hop)).summary)


def test_plan_spec_and_plan_from_summary_match_reference(summaries):
    got, want = pg.plan_from_summary(summaries[0]), \
        ref.plan_from_summary(summaries[1])
    assert got.to_dict() == want.to_dict()
    assert pg.FusionPlanSpec.from_dict(got.to_dict()) == got
    assert got.num_buckets == want.num_buckets
    assert pg.plan_from_summary({"steps": []}) is None


def test_predicted_score_fn_matches_reference():
    kw = {"ici_bytes_per_sec": 150e9, "hop_latency_us": 2.0}
    a = pg.predicted_score_fn(256e6, 8, **kw)
    b = ref.predicted_score_fn(256e6, 8, **kw)
    for e in range(20, 29):
        p = TunableParams(fusion_threshold_bytes=1 << e)
        assert a(p) == b(p)


def _loop(mod, seq_us, analyze=None, anatomy=None, **kw):
    applied = []
    tuner = mod.ProfileGuidedTuner(
        analyze_fn=analyze or (lambda: None), apply_fn=applied.append,
        anatomy_fn=anatomy, window_steps=4, **kw)
    phases = []
    for us in seq_us:
        tuner.on_step(us * 1e-6)
        phases.append(tuner.phase)
    return tuner, applied, phases


def _same_loop(seq_us, summaries=None, compute=False, **kw):
    """The two tuners on the same scripted windows: phases after every
    step, history and applied plans (as dicts) must be equal."""
    out = []
    for i, (mod, ckm) in enumerate(((pg, ck), (ref, ref_ck))):
        summary = summaries[i] if summaries else None
        tuner, applied, phases = _loop(
            mod, seq_us, analyze=(lambda s=summary: s),
            anatomy=ckm.compute_fixture_anatomy if compute else None,
            **kw)
        out.append((phases, tuner.history,
                    [None if p is None else p.to_dict() for p in applied]))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("case", ["verify", "rollback", "keep",
                                  "cycle_flush"])
def test_comm_loop_matches_reference(summaries, case):
    base = AUTOTUNE_EXPECTED["baseline_us"]
    best = AUTOTUNE_EXPECTED["predicted_step_us"]
    seq, kw = {
        "verify": ([base] * 4 + [best] * 4, {}),
        "rollback": ([base] * 8, {}),
        "keep": ([base] * 8, {"rollback": False}),
        "cycle_flush": ([base] * 4 + [best] * 4 + [best] * 10 + [best] * 4,
                        {"cycle_flush_steps": 6}),
    }[case]
    phases, history, applied = _same_loop(seq, summaries, guard_band_pct=10.0,
                                          **kw)
    outcomes = [r["outcome"] for r in history]
    assert outcomes[:2] == {"verify": ["applied", "verified"],
                            "rollback": ["applied", "rolled_back"],
                            "keep": ["applied", "verified"],
                            "cycle_flush": ["applied", "verified"]}[case]
    if case == "rollback":
        assert applied[-1] is None
    if case == "cycle_flush":
        assert "steady" in phases and outcomes[-1] == "retained"


@pytest.mark.parametrize("case", ["two_knobs", "rollback_to_last_good"])
def test_compute_loop_matches_reference(case):
    base, mid = E["baseline_step_us"], E["async_predicted_step_us"]
    done = E["combined_step_us"]
    seq, band = {
        "two_knobs": ([base] * 4 + [mid] * 4 + [mid] * 4 + [done] * 4
                      + [done] * 4, 10.0),
        "rollback_to_last_good": ([base] * 4 + [mid] * 4 + [mid] * 8
                                  + [mid] * 8, 1.0),
    }[case]
    phases, history, applied = _same_loop(seq, compute=True,
                                          guard_band_pct=band)
    assert [r["outcome"] for r in history] == {
        "two_knobs": ["applied", "verified", "applied", "verified"],
        "rollback_to_last_good": ["applied", "verified", "applied",
                                  "rolled_back"]}[case]
    assert phases[-1] == "frozen"


def test_sync_hooks_make_the_same_decisions_as_the_reference(summaries):
    """The multi-process hooks (the process-mean window, process 0's plan
    broadcast), scripted: both tuners take the hooks' numbers and plan
    and decide the same."""
    base = AUTOTUNE_EXPECTED["baseline_us"]
    best = AUTOTUNE_EXPECTED["predicted_step_us"]
    sent = {}

    def plan_sync(d):
        sent.setdefault(len(sent), d)
        return d

    phases, history, applied = _same_loop(
        [base] * 4 + [best] * 4, summaries, guard_band_pct=10.0,
        window_sync=lambda us: us * 1.5 if us < base else us,
        plan_sync=plan_sync)
    assert history[0]["outcome"] == "applied" and len(history) == 2
    assert sent[0]["buckets"] == AUTOTUNE_EXPECTED["optimal_buckets"]


def test_planless_windows_freeze_as_in_the_reference():
    phases, history, _ = _same_loop([100.0] * 40, max_plan_attempts=3)
    assert history == [{"outcome": "no_plan_available", "windows_tried": 3,
                        "plan_id": 0}]
    assert phases[-1] == "frozen"


def test_compute_fixture_is_recovered_exactly():
    assert ck.check_fixture()
    assert E == ref_ck.COMPUTE_AUTOTUNE_EXPECTED
    plans = ck.compute_plans_from_anatomy(ck.compute_fixture_anatomy())
    assert [p.compute for p in plans] == [{ck.KNOB_LOSS_FETCH: 16},
                                          {ck.KNOB_FUSED_OPTIMIZER: True}]
    assert plans[0].predicted_step_us == E["async_predicted_step_us"]
    assert plans[0].predicted_speedup_pct == E["async_speedup_pct"]
    assert plans[1].predicted_step_us == E["fused_predicted_step_us"]
    assert plans[1].predicted_speedup_pct == E["fused_speedup_pct"]


@pytest.mark.parametrize("kw", [
    {}, {"exclude": ("loss_fetch_steps",)}, {"fused_available": False},
    {"loss_fetch_steps": 4, "fused_save_frac": 0.3, "gap_save_frac": 0.5},
])
def test_compute_plans_from_anatomy_match_reference(kw):
    anatomy = ck.compute_fixture_anatomy()
    assert anatomy == ref_ck.compute_fixture_anatomy()
    got = [p.to_dict() for p in ck.compute_plans_from_anatomy(anatomy, **kw)]
    want = [p.to_dict() for p in
            ref_ck.compute_plans_from_anatomy(anatomy, **kw)]
    assert got == want
    assert ck.compute_plans_from_anatomy(None) == []


def test_push_target_raises_until_the_rendezvous_server(monkeypatch):
    with pytest.raises(NotImplementedError, match="autotune plan push"):
        pg.ProfileGuidedTuner(analyze_fn=lambda: None,
                              apply_fn=lambda p: None,
                              push_target=("localhost", 1, None))
    monkeypatch.setenv("HVD_METRICS_KV_ADDR", "localhost")
    monkeypatch.setenv("HVD_METRICS_KV_PORT", "1")
    with pytest.raises(NotImplementedError, match="rendezvous server"):
        pg.tuner_from_env(lambda: None, lambda p: None)


# ---------------------------------------------------------------------------
# the loop in the train step
# ---------------------------------------------------------------------------
@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE", "HVD_PROFILE", "HVD_TIMELINE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def _drive(monkeypatch, steps_us, **kw):
    """The MLP with the fused SGD on its per-leaf path, the
    profile-guided loop on (its analyze idle, its anatomy the compute
    fixture's), the tuner's clock scripted to ``steps_us`` a call."""
    clock = itertools.accumulate([0.0] + [us * 1e-6 for us in steps_us])
    monkeypatch.setattr(training, "_clock", lambda: next(clock))
    model = MLP(12, (16, 6), generator=torch.Generator().manual_seed(0))
    opt = fused_sgd(0.1, momentum=0.9)
    state = training.init_train_state(model, opt)
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt, fused_optimizer=False,
                                    **kw)
    tuner = step.profile_guided_tuner
    if tuner is not None:
        tuner.analyze_fn = lambda: None
        tuner.anatomy_fn = ck.compute_fixture_anatomy
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 12)).astype(np.float32))
    y = torch.tensor([0, 1, 2, 3])
    losses = []
    for _ in range(len(steps_us)):
        state, loss = step(state, x, y)
        losses.append(loss.item())
    return step, losses


@pytest.mark.parametrize("outcome", ["verified", "rolled_back"])
def test_train_step_applies_and_verifies_or_rolls_back(cpu_world,
                                                       monkeypatch, tmp_path,
                                                       outcome):
    monkeypatch.setenv("HVD_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("HVD_AUTOTUNE_WINDOW_STEPS", "4")
    monkeypatch.setenv("HVD_AUTOTUNE_GUARD_BAND_PCT", "1")
    base = E["baseline_step_us"]
    after = E["fused_predicted_step_us"] if outcome == "verified" else base
    steps_us = [base] * 5 + [after] * 4 + [after] * 3
    step, losses = _drive(monkeypatch, steps_us, profile_guided=True)
    tuner = step.profile_guided_tuner
    assert [r["outcome"] for r in tuner.history] == ["applied", outcome]
    assert tuner.history[0]["compute"] == {ck.KNOB_FUSED_OPTIMIZER: True}
    fused = [b["fused"] for b in step.builds]
    assert fused == ([False, True] if outcome == "verified"
                     else [False, True, False])
    assert not tuner.active
    _, plain = _drive(monkeypatch, steps_us, profile_guided=False)
    assert losses == plain


def test_env_profile_guided_without_a_trace_dir_idles(cpu_world,
                                                      monkeypatch):
    monkeypatch.setenv("HVD_AUTOTUNE_PROFILE_GUIDED", "1")
    monkeypatch.delenv("HVD_TRACE_DIR", raising=False)
    model = MLP(12, (16, 6))
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=fused_sgd(0.1))
    assert step.profile_guided_tuner is not None
    assert step.profile_guided_tuner.analyze_fn() is None
    assert step.parameter_manager is None


def test_bench_fixture_runs_on_the_port_mlp(cpu_world):
    """The compute-path A/B on the CPU: its losses agree (the rates are
    host timings and are not checked)."""
    out = ck.run_bench_fixture(steps=6, host_delay_s=0.0, profile_steps=2)
    assert out["loss_equal"], out
    assert out["img_sec_baseline"] > 0 and out["img_sec_optimized"] > 0
    assert out["host_gap_pct"] is not None
