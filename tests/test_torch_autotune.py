"""horovod_tpu_torch.optim.autotune against horovod_tpu.optim.autotune:
the GP, expected improvement, the seeded Bayesian optimizer and the
ParameterManager, and the GP autotuner inside ``make_train_step``.

* The NumPy GP, EI and ``BayesianOptimization`` are the reference's
  arithmetic: equal results, bit for bit.
* Both ParameterManagers are fed the same scripted ``dt(knobs)`` — no
  host clock anywhere — and their ``TunableParams`` trajectories are
  identical: the NumPy path (comm knobs, then the compute knobs), the
  α–β warm start, and the native state machine of ``csrc/autotune.cc``
  (where ``g++`` builds it), whose GP also matches the NumPy GP.
* ``make_train_step(autotune=True)`` on the MLP over 2 gloo processes
  (``torch_dist_worker`` task ``autotune``): both ranks build the same
  knob sequence, and the losses are bit-equal to the untuned run's (the
  bucket layout changes no value); against the reference's
  ``make_train_step(autotune=True)`` on a 2-device mesh, the MLP parity
  tolerance (1e-5) applies.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu import training as ref_training
from horovod_tpu.models.mlp import MLP as RefMLP
from horovod_tpu.optim import autotune as ref
from horovod_tpu.optim import fused_update as ref_fu
from horovod_tpu.optim import profile_guided as ref_pg
from horovod_tpu_torch import core, training
from horovod_tpu_torch.convert import flatten_flax
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.optim import autotune as port
from horovod_tpu_torch.optim import profile_guided as pg
from horovod_tpu_torch.optim.fused_update import fused_sgd
from horovod_tpu_torch.runtime import native
from torch_dist_worker import AUTOTUNE_SPS, AUTOTUNE_STEPS, launch


def test_gp_and_expected_improvement_match_reference():
    rng = np.random.default_rng(0)
    x = rng.uniform(20, 28, size=(9, 1))
    y = np.sin(x[:, 0]) * 3 + rng.normal(size=9) * 0.1
    q = np.linspace(20, 28, 17)[:, None]
    a, b = port.GaussianProcessRegressor(0.7, 1e-3, 1.3), \
        ref.GaussianProcessRegressor(0.7, 1e-3, 1.3)
    a.fit(x, y)
    b.fit(x, y)
    (ma, sa), (mb, sb) = a.predict(q), b.predict(q)
    assert np.array_equal(ma, mb) and np.array_equal(sa, sb)
    assert np.array_equal(port.expected_improvement(ma, sa, 1.5),
                          ref.expected_improvement(mb, sb, 1.5))


def test_bayesian_optimization_suggestions_match_reference():
    a = port.BayesianOptimization([(20.0, 28.0)], noise=0.8, seed=17)
    b = ref.BayesianOptimization([(20.0, 28.0)], noise=0.8, seed=17)
    for i in range(12):
        xa, xb = a.suggest(), b.suggest()
        assert np.array_equal(xa, xb), i
        y = -(float(xa[0]) - 23.5) ** 2 + 0.01 * i
        a.observe(xa, y)
        b.observe(xb, y)
    (va, ya), (vb, yb) = a.best(), b.best()
    assert np.array_equal(va, vb) and ya == yb


@pytest.mark.parametrize("kw", [
    {}, {"hierarchical_allreduce": True, "fusion_threshold_bytes": 1 << 22},
    {"fused_optimizer": False, "remat_policy": "dots"},
])
def test_tunable_params_match_reference(kw):
    a, b = port.TunableParams(**kw), ref.TunableParams(**kw)
    assert np.array_equal(a.as_vector(), b.as_vector())
    assert a.category() == b.category()
    assert a.CONTINUOUS_DIMS == b.CONTINUOUS_DIMS
    assert a.CATEGORICAL_DIMS == b.CATEGORICAL_DIMS


def _dt(p) -> float:
    """The scripted step time of a knob vector: fastest at 2^24 bytes,
    hierarchical 10% slower, the fused optimizer and remat priced too."""
    x = np.log2(p.fusion_threshold_bytes)
    t = 0.05 + 0.01 * (x - 24.0) ** 2
    t *= 1.1 if p.hierarchical_allreduce else 1.0
    t *= 0.9 if p.fused_optimizer else 1.0
    t *= {"full": 1.3, "dots": 1.15}.get(p.remat_policy, 1.0)
    return t


def _knobs(p):
    return (p.fusion_threshold_bytes, p.hierarchical_allreduce,
            p.fused_optimizer, p.remat_policy, p.fusion_plan)


def _trajectory(mod, *, steps=160, warm=None, **kw):
    """The knob vector and frozen flag after every scripted step, and
    the knob vectors ``on_update`` saw."""
    seen = []
    pm = mod.ParameterManager(enabled=True, warmup_samples=1,
                              steps_per_sample=2, on_update=seen.append,
                              **kw)
    if warm is not None:
        warm(pm)
    out = []
    for _ in range(steps):
        pm.record_step(1e8, _dt(pm.current))
        out.append((*_knobs(pm.current), pm.frozen))
    return out, [_knobs(p) for p in seen], pm


@pytest.mark.parametrize("kw", [
    {"max_samples": 20},
    {"tune_hierarchical": False, "max_samples": 12},
    {"tune_fused_optimizer": True, "tune_remat": True},
    {"initial": "pinned"},
])
def test_parameter_manager_trajectories_match_reference(monkeypatch, kw):
    monkeypatch.setenv("HVD_AUTOTUNE_PYTHON", "1")
    kp, kr = dict(kw), dict(kw)
    if kw.get("initial") == "pinned":
        kp["initial"] = port.TunableParams(1 << 21, True, True, "full")
        kr["initial"] = ref.TunableParams(1 << 21, True, True, "full")
        kp["tune_remat"] = kr["tune_remat"] = True
    got, got_upd, pa = _trajectory(port, **kp)
    want, want_upd, pb = _trajectory(ref, **kr)
    assert got == want
    assert got_upd == want_upd and len(got_upd) > 3
    assert pa.frozen == pb.frozen
    assert pa._native is None


def test_warm_started_trajectory_matches_reference(monkeypatch):
    monkeypatch.setenv("HVD_AUTOTUNE_PYTHON", "1")
    link = {"ici_bytes_per_sec": 100e9, "hop_latency_us": 3.0}
    got, _, pa = _trajectory(port, warm=lambda pm: pg.warm_start_manager(
        pm, 5e8, world=8, **link), max_samples=16)
    want, _, pb = _trajectory(ref, warm=lambda pm: ref_pg.warm_start_manager(
        pm, 5e8, world=8, **link), max_samples=16)
    assert got == want
    for cat in pa._bo:
        assert pa._bo[cat].prior_ys == pb._bo[cat].prior_ys
        assert pa._bo[cat].prior_scale == pb._bo[cat].prior_scale


def test_plan_pins_and_clears_as_in_the_reference(monkeypatch):
    monkeypatch.setenv("HVD_AUTOTUNE_PYTHON", "1")
    out = []
    for mod, plan_mod in ((port, pg), (ref, ref_pg)):
        seen = []
        pm = mod.ParameterManager(enabled=True, warmup_samples=0,
                                  steps_per_sample=1, max_samples=40,
                                  on_update=seen.append)
        for _ in range(3):
            pm.record_step(1e8, _dt(pm.current))
        plan = plan_mod.FusionPlanSpec(buckets=[["a"], ["b"]])
        pm.apply_plan(plan)
        frozen = pm.frozen
        pm.record_step(1e8, 1.0)
        pm.clear_plan()
        out.append((frozen, pm.frozen, [_knobs(p)[:4] + (
            None if p.fusion_plan is None else p.fusion_plan.buckets,)
            for p in seen]))
    assert out[0] == out[1]


def test_autotune_log_matches_reference_format(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_AUTOTUNE_PYTHON", "1")
    rows = []
    for mod, name in ((port, "port.csv"), (ref, "ref.csv")):
        pm = mod.ParameterManager(enabled=True, warmup_samples=0,
                                  steps_per_sample=1, max_samples=3,
                                  log_file=str(tmp_path / name))
        for _ in range(4):
            pm.record_step(1e8, _dt(pm.current))
        rows.append([line.split(",")[1:] for line in
                     (tmp_path / name).read_text().splitlines()])
    assert rows[0] == rows[1] and len(rows[0]) == 4


needs_native = pytest.mark.skipif(not native.available(),
                                  reason="g++/make cannot build csrc/ here")


@needs_native
def test_native_tuner_trajectory_matches_reference(monkeypatch):
    monkeypatch.delenv("HVD_AUTOTUNE_PYTHON", raising=False)
    got, got_upd, pa = _trajectory(port, max_samples=10)
    want, want_upd, pb = _trajectory(ref, max_samples=10)
    assert pa._native is not None and pb._native is not None
    assert got == want and got_upd == want_upd
    assert pa.frozen


@needs_native
def test_native_gp_matches_the_numpy_gp():
    lib = native.load()
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=12)
    y = np.sin(3 * x) + 0.05 * rng.normal(size=12)
    gp = port.GaussianProcessRegressor(length_scale=0.3, noise=1e-3)
    gp.fit(x[:, None], y)
    g = lib.hvd_gp_create(0.3, 1e-3, 1.0)
    try:
        lib.hvd_gp_fit(g, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       len(x))
        mu, sd = ctypes.c_double(), ctypes.c_double()
        for q in np.linspace(0, 1, 9):
            lib.hvd_gp_predict(g, float(q), ctypes.byref(mu),
                               ctypes.byref(sd))
            m, s = gp.predict(np.array([[q]]))
            assert abs(mu.value - float(m[0])) < 1e-8
            assert abs(sd.value - float(s[0])) < 1e-8
    finally:
        lib.hvd_gp_destroy(g)


# ---------------------------------------------------------------------------
# the GP in the train step
# ---------------------------------------------------------------------------
def _mlp_problem(n=8):
    rng = np.random.default_rng(21)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = rng.integers(0, 6, size=(n,)).astype(np.int32)
    model = RefMLP(features=(16, 6))
    variables = model.init(jax.random.PRNGKey(3), x)
    return model, jax.tree_util.tree_map(np.asarray, variables), x, y


def _reference_autotuned_losses(model, variables, x, y, monkeypatch):
    monkeypatch.setenv("HVD_AUTOTUNE_WARMUP_SAMPLES", "1")
    monkeypatch.setenv("HVD_AUTOTUNE_STEPS_PER_SAMPLE", str(AUTOTUNE_SPS))
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:2])
    try:
        opt = ref_fu.fused_sgd(0.1, momentum=0.9)
        step = ref_training.make_train_step(
            apply_fn=lambda v, a, train=True: model.apply(v, a),
            loss_fn=lambda lg, lb: optax.
            softmax_cross_entropy_with_integer_labels(lg, lb).mean(),
            optimizer=opt, loss_fetch_steps=0, autotune=True)
        params = variables["params"]
        state = ref_training.TrainState(
            params=params, opt_state=opt.init(params), model_state={},
            step=jnp.zeros((), jnp.int32))
        state = jax.device_put(state, NamedSharding(hvd.core.mesh(), P()))
        xs, ys = ref_training.shard_batch(x), ref_training.shard_batch(y)
        losses = []
        for _ in range(AUTOTUNE_STEPS):
            state, loss = step(state, xs, ys)
            losses.append(float(jax.device_get(loss)))
        return np.asarray(losses)
    finally:
        hvd.shutdown()


def test_autotuned_step_two_ranks_same_knobs_and_untuned_losses(
        tmp_path, monkeypatch):
    model, variables, x, y = _mlp_problem()
    params = flatten_flax(variables["params"])
    np.savez(tmp_path / "inputs.npz", x=x, y=y, in_features=12,
             features=np.array([16, 6]),
             **{f"p:{k}": v for k, v in params.items()})
    rcs, outs = launch("autotune", 2, tmp_path)
    assert rcs == [0, 0], "\n".join(outs)
    got = [dict(np.load(tmp_path / f"autotune.{r}.npz")) for r in (0, 1)]
    # one warm-up sample, then a new knob vector every sample
    assert len(got[0]["thresholds"]) >= AUTOTUNE_STEPS // AUTOTUNE_SPS - 1
    for key in ("thresholds", "hierarchical", "tuned", "plain"):
        assert np.array_equal(got[0][key], got[1][key]), key
    assert np.array_equal(got[0]["tuned"], got[0]["plain"])
    want = _reference_autotuned_losses(model, variables, x, y, monkeypatch)
    np.testing.assert_allclose(got[0]["tuned"], want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def test_env_autotune_builds_a_step_per_knob_vector(cpu_world, monkeypatch):
    """``HVD_AUTOTUNE=1``: a rebuild for every new knob vector and none
    for a repeated one; the GP's compute dimensions join with
    ``HVD_AUTOTUNE_COMPUTE`` (the fused optimizer flips between the
    per-leaf path and K1's on one flat state)."""
    monkeypatch.setenv("HVD_AUTOTUNE", "1")
    monkeypatch.setenv("HVD_AUTOTUNE_COMPUTE", "1")
    monkeypatch.setenv("HVD_AUTOTUNE_WARMUP_SAMPLES", "0")
    monkeypatch.setenv("HVD_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    model = MLP(12, (16, 6), generator=torch.Generator().manual_seed(0))
    opt = fused_sgd(0.1, momentum=0.9)
    state = training.init_train_state(model, opt)
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt)
    pm = step.parameter_manager
    assert pm is not None and step.profile_guided_tuner is None
    x, y = torch.ones(4, 12), torch.tensor([0, 1, 2, 3])
    for _ in range(16):
        state, loss = step(state, x, y)
    sigs = [(b["threshold"], b["hierarchical"], b["fused"], b["remat"])
            for b in step.builds]
    assert len(sigs) == len(step.builds) >= 8
    assert all(a != b for a, b in zip(sigs, sigs[1:]))
    assert {b["fused"] for b in step.builds} == {False, True}
    assert np.isfinite(loss.item()) and state.step == 16
