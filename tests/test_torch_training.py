"""horovod_tpu_torch.training against horovod_tpu.training: 3-step
trajectories of make_train_step from the same weights and batches.

Arrays are compared relative to their largest entry (``_close``): a
parameter's change over 3 steps has entries near 0 that carry no
relative precision of their own.

* MLP, float32, world 1, the fused and the per-leaf update: losses,
  parameter changes to float32 matmul-order error (1e-5).
* narrow ResNet-18 / ResNet-50 (num_filters=8, 64x64, batch 4), world 1,
  in float64 on both sides (the reference inside ``jax.enable_x64``):
  in float32 the reference's own logits are off its float64 logits by
  ~1e-3 at these sizes, which would hide an algorithmic difference.
  Both models still cast the logits to float32, so the loss and its
  gradient carry float32 rounding: losses, parameter changes and
  BatchNorm statistics agree to 1e-6 (measured: 2e-7).  At 32x32 with
  batch 2 the last stage's BatchNorm normalizes over 2 values and turns
  that rounding into differences as large as the update itself.
* MLP on 2 gloo processes against the reference on a 2-device mesh with
  the same global batch.
* the synthetic benchmark's ``run`` on the CPU; the tuners and
  ``donate=False`` build a step that trains (``donate=False`` leaves the
  caller's state as it was and equals ``donate=True``), and the
  profile-guided loop's tuner aims its plan push at the rendezvous
  server's address; the profiler (``profile=True``) runs,
  ``tests/test_torch_profiler.py``.
* the wire tier in the step, world 1: int8 and bf16 compression with
  and without error feedback against the reference's step (losses and
  parameter changes to 1e-5, the residual to 1e-7 absolute: it is the
  difference of two nearly equal float32 numbers), the guard's reads
  and trip, the residual made on the first call, and Adasum,
  hierarchical and two-level reduction equal to the default step bit
  for bit at one rank (4 ranks: ``tests/test_torch_wire.py``).
"""

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
from horovod_tpu.models.resnet import ResNet18 as RefResNet18
from horovod_tpu.models.resnet import ResNet50 as RefResNet50
from horovod_tpu.optim import fused_update as ref_fu
from horovod_tpu_torch import core, training
from horovod_tpu_torch.convert import (
    canonical_layouts, export_flax_variables, flatten_flax,
    load_flax_variables,
)
from horovod_tpu_torch.models import MLP, ResNet18, ResNet50
from horovod_tpu_torch.optim.fused_update import fused_sgd
from horovod_tpu_torch.utils.tree import tree_flatten
from torch_dist_worker import launch

STEPS = 3


def _ref_loss(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, labels).mean()


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def _reference_run(model, variables, x, y, *, ndev, fused, batch_stats,
                   steps=STEPS, remat_policy=None):
    """STEPS steps of the reference's make_train_step on ``ndev`` CPU
    devices; returns (losses, params, batch_stats) as flat numpy dicts."""
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:ndev])
    try:
        opt = ref_fu.fused_sgd(0.1, momentum=0.9)
        if batch_stats:
            apply_fn = model.apply
        else:
            def apply_fn(v, a, train=True):
                return model.apply(v, a)
        step = ref_training.make_train_step(
            apply_fn=apply_fn, loss_fn=_ref_loss, optimizer=opt,
            has_batch_stats=batch_stats, fused_optimizer=fused,
            remat_policy=remat_policy, loss_fetch_steps=0)
        params = variables["params"]
        state = ref_training.TrainState(
            params=params, opt_state=opt.init(params),
            model_state={"batch_stats": variables["batch_stats"]}
            if batch_stats else {},
            step=jnp.zeros((), jnp.int32))
        state = jax.device_put(state, NamedSharding(hvd.core.mesh(), P()))
        xs, ys = ref_training.shard_batch(x), ref_training.shard_batch(y)
        losses = []
        for _ in range(steps):
            state, loss = step(state, xs, ys)
            losses.append(float(jax.device_get(loss)))
        stats = flatten_flax(state.model_state["batch_stats"]) \
            if batch_stats else {}
        return np.asarray(losses), flatten_flax(state.params), stats
    finally:
        hvd.shutdown()


def _port_run(model, x, y, *, fused, batch_stats, steps=STEPS,
              remat_policy=None):
    opt = fused_sgd(0.1, momentum=0.9)
    step = training.make_train_step(
        apply_fn=model, loss_fn=F.cross_entropy, optimizer=opt,
        has_batch_stats=batch_stats, fused_optimizer=fused,
        remat_policy=remat_policy, loss_fetch_steps=0)
    state = training.init_train_state(model, opt,
                                      has_batch_stats=batch_stats)
    xs = training.shard_batch(torch.from_numpy(x))
    ys = training.shard_batch(torch.from_numpy(y).long())
    losses = []
    for _ in range(steps):
        state, loss = step(state, xs, ys)
        losses.append(loss.item())
    assert state.step == steps and int(state.opt_state.count) == steps
    stats = {k: t.numpy() for k, t in state.model_state.items()}
    return np.asarray(losses), export_flax_variables(
        state.params, canonical_layouts(model)), stats


def _close(got, want, tol, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(),
                               err_msg=err_msg)


def _assert_trajectories_match(port, ref, params0, tol, change_tol=None):
    """Losses, the parameters' change over the run (so the comparison
    sees the gradients, not the initial weights, to ``change_tol``,
    default ``tol``) and the statistics."""
    (pl, pp, ps), (rl, rp, rs) = port, ref
    _close(pl, rl, tol)
    assert list(pp) == list(rp) and list(ps) == list(rs)
    for k in rp:
        _close(pp[k] - params0[k], rp[k] - params0[k], change_tol or tol, k)
    for k in rs:
        _close(ps[k], rs[k], tol, k)


def _mlp_problem(n=8):
    rng = np.random.default_rng(21)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = rng.integers(0, 6, size=(n,)).astype(np.int32)
    ref = RefMLP(features=(16, 6))
    variables = ref.init(jax.random.PRNGKey(3), x)
    return ref, jax.tree_util.tree_map(np.asarray, variables), x, y


@pytest.mark.parametrize("fused", [True, False])
def test_mlp_trajectory_matches_reference(port_cpu_world, fused):
    ref, variables, x, y = _mlp_problem()
    want = _reference_run(ref, variables, x, y, ndev=1, fused=fused,
                          batch_stats=False)
    model = MLP(12, (16, 6))
    load_flax_variables(model, variables["params"])
    got = _port_run(model, x, y, fused=fused, batch_stats=False)
    _assert_trajectories_match(got, want, flatten_flax(variables["params"]),
                               1e-5)


def _resnet_variables(ref_cls, x):
    ref = ref_cls(num_classes=10, num_filters=8, dtype=jnp.float32)
    variables = ref.init(jax.random.PRNGKey(0), x)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), variables)


@pytest.mark.parametrize("name,fused", [("ResNet18", True),
                                        ("ResNet18", False),
                                        ("ResNet50", True)])
def test_resnet_trajectory_matches_reference_float64(port_cpu_world, name,
                                                     fused):
    ref_cls, cls = {"ResNet18": (RefResNet18, ResNet18),
                    "ResNet50": (RefResNet50, ResNet50)}[name]
    rng = np.random.default_rng(31)
    x = rng.uniform(size=(4, 64, 64, 3))
    y = rng.integers(0, 10, size=(4,)).astype(np.int32)
    variables = _resnet_variables(ref_cls, x.astype(np.float32))
    with jax.enable_x64(True):
        ref = ref_cls(num_classes=10, num_filters=8, dtype=jnp.float64,
                      param_dtype=jnp.float64)
        want = _reference_run(ref, variables, x, y, ndev=1, fused=fused,
                              batch_stats=True)
    model = cls(num_classes=10, num_filters=8, dtype=torch.float32)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    got = _port_run(model.double(), x, y, fused=fused, batch_stats=True)
    _assert_trajectories_match(got, want, flatten_flax(variables["params"]),
                               1e-6)


#: the reference's three kernel options, all on
ALL_VARIANTS = {"norm_act": "pallas", "residual_join": "pallas",
                "conv_bn": "pallas"}


@pytest.mark.slow  # ~35 s: the reference's step through interpret-mode Pallas
def test_variant_resnet18_trajectory_matches_reference(port_cpu_world):
    """ResNet-18 with all three kernel options (K6, K7, K8-K10's plain
    versions here) trained 2 steps against the reference's make_train_step
    with the same options, from the same weights and batch.  In float32
    on both sides: the Pallas bodies accumulate in float32 even under
    jax.enable_x64, so the float64 pinning of the plain models does not
    carry over.  At 64x64, batch 4, no BatchNorm normalizes fewer than
    16 values.  Losses and statistics agree to 1e-4 of their largest
    entry (read: 4.8e-6, 8.2e-6); each parameter's change over the run to
    2e-2 of its largest entry (read: 6.7e-3, a BatchNorm bias whose
    gradient is a sum with much cancellation, so float32 rounding of the
    terms shows in it).  The port's CPU convolutions
    run without oneDNN: its float32 convolution backward aborts the
    process at this size in torch 2.13's CPU build (the plain model
    too), which the float64 tests above never reach."""
    rng = np.random.default_rng(31)
    x = rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(4,)).astype(np.int32)
    ref = RefResNet18(num_classes=10, num_filters=8, dtype=jnp.float32,
                      **ALL_VARIANTS)
    variables = jax.tree_util.tree_map(
        np.asarray, ref.init(jax.random.PRNGKey(0), x))
    want = _reference_run(ref, variables, x, y, ndev=1, fused=True,
                          batch_stats=True, steps=2)
    model = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32,
                     **ALL_VARIANTS)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    with torch.backends.mkldnn.flags(enabled=False):
        got = _port_run(model, x, y, fused=True, batch_stats=True, steps=2)
    _assert_trajectories_match(got, want, flatten_flax(variables["params"]),
                               1e-4, change_tol=2e-2)


def test_fused_and_per_leaf_steps_are_bit_identical(port_cpu_world):
    """The fused_optimizer knob changes the route, not the numbers."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(2,)).astype(np.int32)
    runs = []
    for fused in (True, False):
        model = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))
        runs.append(_port_run(model, x, y, fused=fused, batch_stats=True))
    for a, b in zip(runs[0], runs[1]):
        if isinstance(a, dict):
            assert all(np.array_equal(a[k], b[k]) for k in a)
        else:
            assert np.array_equal(a, b)


def test_two_gloo_ranks_match_reference_two_device_mesh(tmp_path):
    ref, variables, x, y = _mlp_problem(n=8)
    want = _reference_run(ref, variables, x, y, ndev=2, fused=True,
                          batch_stats=False)
    params = flatten_flax(variables["params"])
    np.savez(tmp_path / "inputs.npz", x=x, y=y, in_features=12,
             features=np.array([16, 6]),
             **{f"p:{k}": v for k, v in params.items()})
    rcs, outs = launch("train_mlp", 2, tmp_path)
    assert rcs == [0, 0], "\n".join(outs)
    for r in range(2):
        got = dict(np.load(tmp_path / f"train_mlp.{r}.npz"))
        got_params = {k[len("p:"):]: v for k, v in got.items()
                      if k.startswith("p:")}
        _assert_trajectories_match((got["losses"], got_params, {}), want,
                                   params, 1e-5)


def test_in_graph_steps_runs_k_steps_per_call(port_cpu_world):
    ref, variables, x, y = _mlp_problem()
    models = []
    for _ in range(2):
        m = MLP(12, (16, 6))
        load_flax_variables(m, variables["params"])
        models.append(m)
    opt = fused_sgd(0.1, momentum=0.9)
    one = training.make_train_step(apply_fn=models[0],
                                   loss_fn=F.cross_entropy, optimizer=opt)
    three = training.make_train_step(apply_fn=models[1],
                                     loss_fn=F.cross_entropy, optimizer=opt,
                                     in_graph_steps=STEPS)
    s1 = training.init_train_state(models[0], opt)
    s3 = training.init_train_state(models[1], opt)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    for _ in range(STEPS):
        s1, l1 = one(s1, xt, yt)
    s3, l3 = three(s3, xt, yt)
    assert s3.step == STEPS and torch.equal(l1, l3)
    for k in s1.params:
        assert torch.equal(s1.params[k], s3.params[k])


def test_trailing_loss_fetcher_reads_one_cadence_behind():
    f = training.TrailingLossFetcher(2)
    for i in range(1, 7):
        f.push(torch.tensor(float(i)))
    assert (f.value, f.step) == (4.0, 4)      # 6 is retained, unread
    assert f.flush() == 6.0 and f.step == 6
    off = training.TrailingLossFetcher(0)
    off.push(torch.tensor(1.0))
    assert off.flush() is None


#: a rendezvous server's address, where the profile-guided loop pushes
#: its plan records
_KV = {"HVD_METRICS_KV_ADDR": "localhost", "HVD_METRICS_KV_PORT": "1"}


@pytest.mark.parametrize("kw,env", [
    ({"profile_guided": True}, _KV),
    ({}, {"HVD_AUTOTUNE_PROFILE_GUIDED": "1", **_KV}),
])
def test_unported_knobs_raise(port_cpu_world, monkeypatch, kw, env):
    """Named for what it held before the rendezvous plane was ported (the
    profile-guided loop's plan push raised when the server's address was
    set); now the step's tuner pushes to that address."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    step = training.make_train_step(apply_fn=MLP(4), loss_fn=F.cross_entropy,
                                    optimizer=fused_sgd(0.1), **kw)
    assert step.profile_guided_tuner.push_target == ("localhost", 1, None)


@pytest.mark.parametrize("kw,env", [
    ({"autotune": True}, {}),
    ({"profile_guided": True}, {}),
    ({}, {"HVD_AUTOTUNE_PROFILE_GUIDED": "1", "HVD_AUTOTUNE": "1"}),
    ({"donate": False}, {}),
])
def test_tuner_and_donate_knobs_build_a_step(port_cpu_world, monkeypatch,
                                             kw, env):
    """The tuners and ``donate=False`` are ported: each builds a step that
    trains (tests/test_torch_autotune.py and test_torch_profile_guided.py
    hold them against the reference)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    model = MLP(4, (3,))
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=fused_sgd(0.1), **kw)
    state = training.init_train_state(model, fused_sgd(0.1))
    x, y = torch.ones(2, 4), torch.zeros(2, dtype=torch.long)
    for _ in range(3):
        state, loss = step(state, x, y)
    assert state.step == 3 and np.isfinite(loss.item())
    assert (step.parameter_manager is not None) == bool(
        kw.get("autotune") or env.get("HVD_AUTOTUNE"))
    assert (step.profile_guided_tuner is not None) == bool(
        kw.get("profile_guided") or env.get("HVD_AUTOTUNE_PROFILE_GUIDED"))


def test_donate_false_leaves_the_callers_state_and_equals_donate(
        port_cpu_world):
    """``donate=False``: every call returns a new state and leaves the
    one it was given as it was; the trajectory equals ``donate=True``'s
    bit for bit, BatchNorm statistics included (narrow ResNet-18)."""
    runs = []
    for donate in (True, False):
        torch.manual_seed(0)
        model = ResNet18(num_classes=4, num_filters=4).double()
        opt = fused_sgd(0.1, momentum=0.9)
        state = training.init_train_state(model, opt, has_batch_stats=True)
        step = training.make_train_step(
            apply_fn=model, loss_fn=F.cross_entropy, optimizer=opt,
            has_batch_stats=True, donate=donate)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(4, 32, 32, 3, generator=gen, dtype=torch.float64)
        y = torch.tensor([0, 1, 2, 3])
        losses = []
        for _ in range(2):
            before = [t.clone() for t in training._state_tensors(state)]
            new, loss = step(state, x, y)
            after = training._state_tensors(state)
            if not donate:
                assert all(torch.equal(a, b) for a, b in zip(before, after))
                assert all(a.data_ptr() != b.data_ptr() for a, b in
                           zip(training._state_tensors(new), after))
            state = new
            losses.append(loss.item())
        runs.append((losses, [t.detach().clone()
                              for t in training._state_tensors(state)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("how", ["argument", "env"])
def test_profile_runs_instead_of_raising(port_cpu_world, monkeypatch,
                                         tmp_path, how):
    """The compute-anatomy profiler is ported: ``profile=True`` (or
    ``HVD_PROFILE=1``) builds a step whose window writes compute.json;
    without a trace directory there is no profiler, as in the
    reference."""
    model = MLP(4, (3,))
    kw = {"profile": True} if how == "argument" else {}
    monkeypatch.setenv("HVD_PROFILE", "1")
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=fused_sgd(0.1), **kw)
    assert step.profiler is None
    monkeypatch.setenv("HVD_TRACE_DIR", str(tmp_path))
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=fused_sgd(0.1), **kw)
    state = training.init_train_state(model, fused_sgd(0.1))
    x, y = torch.ones(2, 4), torch.zeros(2, dtype=torch.long)
    for _ in range(4):
        state, loss = step(state, x, y)
    assert step.profiler.anatomy["steps"] == 3
    assert (tmp_path / "0" / "compute.json").exists()
    assert state.step == 4 and np.isfinite(loss.item())


def test_optax_optimizer_is_refused():
    with pytest.raises(TypeError, match="FusedOptimizer"):
        training.make_train_step(apply_fn=MLP(4), loss_fn=F.cross_entropy,
                                 optimizer=torch.optim.SGD)


def test_synthetic_benchmark_runs_on_cpu(monkeypatch):
    from horovod_tpu_torch.examples import synthetic_benchmark as sb

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    try:
        out = sb.run(sb.parse_args([
            "--model", "ResNet18", "--image-size", "32", "--batch-size", "2",
            "--num-classes", "10", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "2", "--num-iters", "2",
            "--fused-optimizer", "--device", "cpu"]))
    finally:
        core.shutdown()
    assert set(out) == {"img_sec_total", "img_sec_per_chip", "conf", "size",
                        "final_loss", "step_calls"}
    # on the CPU every call runs the eager loop: 1 warm-up + 2 x 2 timed
    assert out["step_calls"] == {"eager": 5, "capture": 0, "replay": 0}
    assert out["size"] == 1 and np.isfinite(out["final_loss"])
    assert out["img_sec_per_chip"] > 0


def test_synthetic_benchmark_then_gets_the_timed_step(monkeypatch):
    """``run(args, then=fn)`` calls ``fn`` once, after the timed window,
    with the step that was timed, its state and its inputs; the result's
    ``step_calls`` are those of the timed run, before ``fn``'s calls."""
    from horovod_tpu_torch.examples import synthetic_benchmark as sb

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    seen = []

    def then(step, state, x, y):
        seen.append(dict(step.calls))
        state, loss = step(state, x, y)
        return {"step": state.step, "x": tuple(x.shape), "loss": float(loss)}

    core.shutdown()
    try:
        out = sb.run(sb.parse_args([
            "--model", "ResNet18", "--image-size", "32", "--batch-size", "2",
            "--num-classes", "10", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "1", "--num-iters", "2",
            "--fused-optimizer", "--device", "cpu"]), then=then)
    finally:
        core.shutdown()
    assert seen == [{"eager": 3, "capture": 0, "replay": 0}]
    assert out["step_calls"] == seen[0]
    assert out["then"]["step"] == 4 and out["then"]["x"] == (2, 32, 32, 3)
    assert np.isfinite(out["then"]["loss"])


def test_synthetic_benchmark_runs_the_kernel_variants_on_cpu(monkeypatch):
    """``--norm-act/--residual-join/--conv-bn pallas`` through the
    benchmark's ``run``; on the CPU every join takes its kernel's plain
    version, so no kernel launches."""
    from horovod_tpu_torch import kernels
    from horovod_tpu_torch.examples import synthetic_benchmark as sb

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    before = {**kernels.elementwise_launches, **kernels.conv_bn_launches}
    core.shutdown()
    try:
        out = sb.run(sb.parse_args([
            "--model", "ResNet18", "--image-size", "32", "--batch-size", "2",
            "--num-classes", "10", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "1", "--num-iters", "1",
            "--fused-optimizer", "--device", "cpu", "--norm-act", "pallas",
            "--residual-join", "pallas", "--conv-bn", "pallas"]))
    finally:
        core.shutdown()
    assert np.isfinite(out["final_loss"]) and out["img_sec_per_chip"] > 0
    assert {**kernels.elementwise_launches,
            **kernels.conv_bn_launches} == before



def test_cpu_step_runs_eagerly_and_counts_its_calls(port_cpu_world):
    """On the CPU every call of the step is the eager loop; ``step.eager``
    is the same step and gives the same numbers; ``step.calls`` counts
    both, and each call returns a loss tensor of its own."""
    _, variables, x, y = _mlp_problem()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    runs = []
    for use_eager in (False, True):
        model = MLP(12, (16, 6))
        load_flax_variables(model, variables["params"])
        opt = fused_sgd(0.1, momentum=0.9)
        step = training.make_train_step(apply_fn=model,
                                        loss_fn=F.cross_entropy,
                                        optimizer=opt, in_graph_steps=2,
                                        loss_fetch_steps=1)
        state = training.init_train_state(model, opt)
        run = step.eager if use_eager else step
        losses = []
        for _ in range(3):
            state, loss = run(state, xt, yt)
            losses.append(loss)
        assert step.calls == {"eager": 3, "capture": 0, "replay": 0}
        assert state.step == 6 and int(state.opt_state.count) == 6
        assert len({id(t) for t in losses}) == 3
        assert step.loss_fetcher.flush() == losses[-1].item()
        runs.append((losses, state.params))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)



# ---------------------------------------------------------------------------
# the wire tier in the step (the 4-rank forms: tests/test_torch_wire.py)
# ---------------------------------------------------------------------------
def _reference_compressed_run(model, variables, x, y, name, steps=STEPS):
    """The reference's make_train_step with the compression ``name`` on a
    1-device mesh (an error-feedback state gets its zero residual);
    returns (losses, params, residual) as flat numpy dicts."""
    from horovod_tpu.ops.compression import Compression as RefCompression

    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        opt = ref_fu.fused_sgd(0.1, momentum=0.9)
        step = ref_training.make_train_step(
            apply_fn=lambda v, a, train=True: model.apply(v, a),
            loss_fn=_ref_loss, optimizer=opt, loss_fetch_steps=0,
            compression=RefCompression.lookup(name))
        params = variables["params"]
        state = ref_training.TrainState(
            params=params, opt_state=opt.init(params), model_state={},
            step=jnp.zeros((), jnp.int32),
            residual=jax.tree_util.tree_map(jnp.zeros_like, params)
            if name.startswith("ef_") else ())
        state = jax.device_put(state, NamedSharding(hvd.core.mesh(), P()))
        xs, ys = ref_training.shard_batch(x), ref_training.shard_batch(y)
        losses = []
        for _ in range(steps):
            state, loss = step(state, xs, ys)
            losses.append(float(jax.device_get(loss)))
        res = flatten_flax(jax.tree_util.tree_map(np.asarray, state.residual)) \
            if name.startswith("ef_") else {}
        return np.asarray(losses), flatten_flax(state.params), res
    finally:
        hvd.shutdown()


def _port_compressed(name, **kw):
    from horovod_tpu_torch.ops.compression import Compression

    _, variables, x, y = _mlp_problem()
    model = MLP(12, (16, 6))
    load_flax_variables(model, variables["params"])
    opt = fused_sgd(0.1, momentum=0.9)
    comp = Compression.lookup(name)
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt, compression=comp,
                                    loss_fetch_steps=0, **kw)
    state = training.init_train_state(model, opt, compression=comp)
    return step, state, torch.from_numpy(x), torch.from_numpy(y).long()


@pytest.mark.parametrize("name", ["ef_int8", "int8", "ef_bf16", "bf16"])
def test_compressed_mlp_trajectory_matches_reference(port_cpu_world, name):
    ref, variables, x, y = _mlp_problem()
    want_l, want_p, want_r = _reference_compressed_run(ref, variables, x, y,
                                                       name)
    step, state, xt, yt = _port_compressed(name)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, xt, yt)
        losses.append(loss.item())
    params0 = flatten_flax(variables["params"])
    got_p = export_flax_variables(state.params, canonical_layouts(
        MLP(12, (16, 6))))
    _assert_trajectories_match((np.asarray(losses), got_p, {}),
                               (want_l, want_p, {}), params0, 1e-5)
    if want_r:
        got_r = export_flax_variables(state.residual, canonical_layouts(
            MLP(12, (16, 6))))
        # the residual is x - dq(q(x)), two nearly equal float32 numbers:
        # it carries the absolute rounding of the gradient x (|x| < 1,
        # ulp 6e-8), not a precision relative to itself
        assert sorted(got_r) == sorted(want_r)
        for k in want_r:
            np.testing.assert_allclose(got_r[k], want_r[k], rtol=0,
                                       atol=1e-7, err_msg=k)


def test_guard_reads_once_a_window_and_trips_to_uncompressed(
        port_cpu_world, monkeypatch):
    """One residual-norm read every HVD_COMPRESSION_GUARD_STEPS calls; an
    injected blow-up trips the guard, the step is rebuilt without
    compression (counted, and training goes on) and the residual stays
    as it was."""
    monkeypatch.setenv("HVD_COMPRESSION_GUARD_STEPS", "2")
    step, state, xt, yt = _port_compressed("ef_int8")
    for _ in range(7):
        state, _ = step(state, xt, yt)
    assert step.guard["reads"] == 3 and step.guard["trips"] == 0
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():         # a residual 1e7 times any gradient
        for r in state.residual.values():
            r.copy_(torch.randn(r.shape, generator=gen) * 1e7)
    state, loss = step(state, xt, yt)
    assert step.guard["trips"] == 1 and step.guard["reads"] == 4
    frozen = {k: v.clone() for k, v in state.residual.items()}
    for _ in range(6):
        state, loss = step(state, xt, yt)
    assert np.isfinite(loss.item()) and step.guard["reads"] == 4
    assert all(torch.equal(state.residual[k], frozen[k]) for k in frozen)


def test_error_feedback_needs_a_residual_for_several_steps_a_call(
        port_cpu_world):
    from horovod_tpu_torch.ops.compression import Compression

    _, variables, x, y = _mlp_problem()
    model = MLP(12, (16, 6))
    opt = fused_sgd(0.1)
    step = training.make_train_step(
        apply_fn=model, loss_fn=F.cross_entropy, optimizer=opt,
        compression=Compression.lookup("ef_int8"), in_graph_steps=2)
    state = training.init_train_state(model, opt)      # no residual
    with pytest.raises(ValueError, match="initialized residual"):
        step(state, torch.from_numpy(x), torch.from_numpy(y).long())
    with pytest.raises(ValueError, match="not Adasum"):
        training.make_train_step(
            apply_fn=model, loss_fn=F.cross_entropy, optimizer=opt,
            compression=Compression.lookup("ef_int8"), op="Adasum")


def test_residual_made_on_the_first_call(port_cpu_world, monkeypatch):
    """``HVD_COMPRESSION=bf16`` is error feedback by default: a state
    made without it gets its residual on the first call."""
    monkeypatch.setenv("HVD_COMPRESSION", "bf16")
    _, variables, x, y = _mlp_problem()
    model = MLP(12, (16, 6))
    opt = fused_sgd(0.1)
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt)
    state = training.init_train_state(model, opt)
    assert state.residual == ()
    state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y).long())
    assert sorted(state.residual) == sorted(state.params)
    assert any(r.abs().sum() > 0 for r in state.residual.values())


@pytest.mark.parametrize("kw,env", [
    ({"op": "Adasum"}, {}),
    ({"hierarchical": True}, {}),
    ({"two_level": True}, {}),
    ({}, {"HVD_TWO_LEVEL_ALLREDUCE": "1"}),
])
def test_one_rank_reductions_equal_the_default(port_cpu_world, monkeypatch,
                                               kw, env):
    """At one rank Adasum is the identity, and the hierarchical and
    two-level reductions fall back to the flat one: the trajectory is
    the default step's, bit for bit."""
    from horovod_tpu_torch import metrics

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    runs = []
    for extra in (kw, {"two_level": False}):
        _, variables, x, y = _mlp_problem()
        model = MLP(12, (16, 6))
        load_flax_variables(model, variables["params"])
        opt = fused_sgd(0.1, momentum=0.9)
        step = training.make_train_step(apply_fn=model,
                                        loss_fn=F.cross_entropy,
                                        optimizer=opt, **extra)
        state = training.init_train_state(model, opt)
        before = metrics.TWO_LEVEL_FALLBACKS.get()
        for _ in range(2):
            state, loss = step(state, torch.from_numpy(x),
                               torch.from_numpy(y).long())
        runs.append((loss, dict(state.params),
                     metrics.TWO_LEVEL_FALLBACKS.get() - before))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[1][1])
    two_level = kw.get("two_level") or env
    assert runs[0][2] == (2 * 4 if two_level else 0)   # 4 leaves, 2 steps
    assert runs[1][2] == 0


def test_float8_wire_is_refused_on_the_cpu(port_cpu_world):
    step, state, xt, yt = _port_compressed("fp8_e4m3")
    with pytest.raises(RuntimeError, match="gloo cannot reduce"):
        step(state, xt, yt)


@pytest.mark.parametrize("argv", [["--compression", "int8"],
                                  ["--compression", "bf16"], ["--adasum"],
                                  ["--hierarchical"]])
def test_synthetic_benchmark_wire_flags_on_cpu(monkeypatch, argv):
    """The reference's bench flags of the wire tier, at one rank on the
    CPU: a finite loss, and with a quantizer the error-feedback residual
    made by init_train_state."""
    from horovod_tpu_torch.examples import synthetic_benchmark as sb

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_COMPRESSION", "HVD_COMPRESSION_ERROR_FEEDBACK"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    try:
        out = sb.run(sb.parse_args([
            "--model", "ResNet18", "--image-size", "32", "--batch-size", "2",
            "--num-classes", "10", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "1", "--num-iters", "1",
            "--fused-optimizer", "--device", "cpu"] + argv),
            then=lambda step, state, x, y: len(
                tree_flatten(state.residual)[0]))
    finally:
        core.shutdown()
    assert np.isfinite(out["final_loss"])
    assert out["then"] == (62 if "--compression" in argv else 0)
