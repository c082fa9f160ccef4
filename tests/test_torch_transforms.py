"""horovod_tpu_torch.optim.transforms against optax: ``sgd``, ``adam``
and ``adamw`` over several steps from the same seeded parameters and
gradients, float32 and bf16 leaves, updates and states compared.

Both sides compute the same expressions in the same order and type, so
float32 results agree to a few float32 ulps (``rtol`` 1e-6, the bound
optax's own tests hold its optimizers to against their reference
implementations).  bf16 leaves agree to 4 bf16 ulps (2^-6 relative):
torch rounds every operation of the update to bf16, while XLA on the CPU
keeps the intermediates of a fused bf16 expression in float32 (its
default excess precision), so each of the update's chained operations
may land one ulp apart.  Arrays are compared relative to the largest
entry of their whole tree: a leaf whose update cancels (the decay
against the Adam step) keeps no relative precision of its own."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu_torch.optim import transforms as tx
from horovod_tpu_torch.utils.tree import tree_flatten

STEPS = 5
SHAPES = {"a/kernel": (7, 5), "a/bias": (5,), "b/kernel": (3, 3, 2, 4),
          "c": (1,)}
TOL = {np.float32: 1e-6, jnp.bfloat16: 2 ** -6}

CASES = {
    "sgd": (lambda: optax.sgd(0.01, momentum=0.9),
            lambda: tx.sgd(0.01, momentum=0.9)),
    "sgd_plain": (lambda: optax.sgd(0.1), lambda: tx.sgd(0.1)),
    "adam": (lambda: optax.adam(1e-3), lambda: tx.adam(1e-3)),
    "adamw": (lambda: optax.adamw(1e-4), lambda: tx.adamw(1e-4)),
    "adamw_wd": (lambda: optax.adamw(1e-2, b1=0.8, b2=0.95, eps=1e-6,
                                     weight_decay=0.1),
                 lambda: tx.adamw(1e-2, b1=0.8, b2=0.95, eps=1e-6,
                                  weight_decay=0.1)),
}


def _draw(seed, dtype):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32).astype(dtype)
            for k, s in SHAPES.items()}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _scale(tree) -> float:
    return max(float(np.abs(np.asarray(v, np.float32)).max())
               for v in jax.tree_util.tree_leaves(tree))


def _close(got, want, tol, scale, what):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_transform_matches_optax_over_steps(case, dtype):
    ref_opt, opt = (make() for make in CASES[case])
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    params0 = _draw(0, np.float32)
    ref_params = {k: jnp.asarray(v, dtype) for k, v in params0.items()}
    params = {k: torch.from_numpy(v).to(tdt) for k, v in params0.items()}
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    held = [t.data_ptr() for t in tree_flatten(state)[0]]
    tol = TOL[dtype]
    for step in range(STEPS):
        grads = _draw(10 + step, np.float32)
        ref_upd, ref_state = ref_opt.update(
            {k: jnp.asarray(v, dtype) for k, v in grads.items()}, ref_state,
            ref_params)
        ref_params = optax.apply_updates(ref_params, ref_upd)
        upd, state = opt.update(
            {k: torch.from_numpy(v).to(tdt) for k, v in grads.items()},
            state, params)
        tx.apply_updates(params, upd)
        for k in SHAPES:
            assert upd[k].dtype == tdt
            _close(_np(upd[k]), ref_upd[k], tol, _scale(ref_upd),
                   f"step {step} update {k}")
            _close(_np(params[k]), ref_params[k], tol, _scale(ref_params),
                   f"step {step} param {k}")
    ref_leaves = jax.tree_util.tree_leaves(ref_state)
    leaves = tree_flatten(state)[0]
    assert len(leaves) == len(ref_leaves)
    counts = [(g, w) for g, w in zip(leaves, ref_leaves)
              if g.dtype == torch.int32]
    assert [(int(g), int(w)) for g, w in counts] == [(STEPS, STEPS)] * len(
        counts)
    moments = [(g, w) for g, w in zip(leaves, ref_leaves)
               if g.dtype != torch.int32]
    # each moment tree (trace, mu, nu) holds one leaf per parameter
    for i in range(0, len(moments), len(SHAPES)):
        tree = moments[i:i + len(SHAPES)]
        scale = _scale([w for _, w in tree])
        for got, want in tree:
            assert got.dtype == tdt
            _close(_np(got), want, tol, scale, "state")
    # the state's tensors were updated in place
    assert [t.data_ptr() for t in tree_flatten(state)[0]] == held


def test_adam_count_and_moments_live_with_the_parameters():
    params = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    (adam_state, decay_state, scale_state) = tx.adamw(1e-4).init(params)
    assert adam_state.count.dtype == torch.int32
    assert adam_state.count.shape == ()
    assert adam_state.mu["w"].dtype == adam_state.nu["w"].dtype == \
        torch.bfloat16
    assert decay_state == scale_state == tx.EmptyState()


def test_decayed_weights_need_the_parameters():
    opt = tx.adamw(1e-4)
    params = {"w": torch.ones(2)}
    with pytest.raises(ValueError, match="parameters"):
        opt.update({"w": torch.ones(2)}, opt.init(params))


# ---------------------------------------------------------------------------
# through make_train_step: the reference's per-leaf optax path
# ---------------------------------------------------------------------------
@pytest.fixture()
def port_cpu_world(monkeypatch):
    from horovod_tpu_torch import core

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE", "HVD_FUSED_OPTIMIZER"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


TRAIN_CASES = {"sgd": (lambda: optax.sgd(0.1, momentum=0.9),
                       lambda: tx.sgd(0.1, momentum=0.9)),
               "adamw": (lambda: optax.adamw(1e-2), lambda: tx.adamw(1e-2))}


@pytest.mark.parametrize("fused", [None, True])
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_with_a_transform_matches_reference(port_cpu_world,
                                                       case, fused):
    """3 steps of the MLP through both packages' make_train_step with the
    optax optimizer and its port, from the same weights and batch:
    losses and parameters to float32 matmul-order error (1e-5 of the
    largest entry).  ``fused_optimizer=True`` keeps the per-leaf path on
    both sides, as the reference does for an optimizer it cannot fuse."""
    import torch.nn.functional as F
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as hvd
    from horovod_tpu import training as ref_training
    from horovod_tpu.models.mlp import MLP as RefMLP
    from horovod_tpu_torch import training
    from horovod_tpu_torch.convert import (
        canonical_layouts, export_flax_variables, flatten_flax,
        load_flax_variables,
    )
    from horovod_tpu_torch.models import MLP

    rng = np.random.default_rng(21)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    y = rng.integers(0, 6, size=(8,)).astype(np.int32)
    ref = RefMLP(features=(16, 6))
    params = jax.tree_util.tree_map(
        np.asarray, ref.init(jax.random.PRNGKey(3), x)["params"])
    make_ref, make_port = TRAIN_CASES[case]

    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        opt = make_ref()
        step = ref_training.make_train_step(
            apply_fn=lambda v, a, train=True: ref.apply(v, a),
            loss_fn=lambda lg, lb: optax.
            softmax_cross_entropy_with_integer_labels(lg, lb).mean(),
            optimizer=opt, fused_optimizer=fused, loss_fetch_steps=0)
        state = jax.device_put(ref_training.TrainState(
            params=params, opt_state=opt.init(params), model_state={},
            step=jnp.zeros((), jnp.int32)),
            NamedSharding(hvd.core.mesh(), P()))
        want_losses = []
        for _ in range(3):
            state, loss = step(state, ref_training.shard_batch(x),
                               ref_training.shard_batch(y))
            want_losses.append(float(jax.device_get(loss)))
        want = flatten_flax(state.params)
    finally:
        hvd.shutdown()

    model = MLP(12, (16, 6))
    load_flax_variables(model, params)
    opt = make_port()
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt, fused_optimizer=fused,
                                    loss_fetch_steps=0)
    state = training.init_train_state(model, opt)
    held = [t.data_ptr() for t in tree_flatten(state.opt_state)[0]]
    losses = []
    for _ in range(3):
        state, loss = step(state, torch.from_numpy(x),
                           torch.from_numpy(y).long())
        losses.append(loss.item())
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = export_flax_variables(state.params, canonical_layouts(model))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    assert [t.data_ptr() for t in tree_flatten(state.opt_state)[0]] == held
