"""The wire tier across ranks: one 4-rank gloo job, 2 ranks a host
(``tests/torch_dist_worker.py``, task ``wire``), held against the JAX
package's numpy oracles and its collectives on a 4-device CPU mesh with
the same local size, from the same per-rank inputs.

* error feedback over int8, 3 steps of ``fused_allreduce``: each step's
  mean and every rank's residual against ``numpy_error_feedback_reduce``
  (to 1e-5, the reference's own tolerance for it), one MAX all-reduce a
  call for the scales, and a float8 wire refused on gloo;
* Adasum flat, hierarchical and over the process set {0, 2} against
  ``numpy_adasum`` / ``numpy_hierarchical_adasum`` and the reference's
  mesh (to 1e-5: float32 dots in another order), bit-identical on every
  rank; a set of 3 ranks raises;
* ``hierarchical_allreduce``, ``two_level_allreduce`` (int8 on the cross
  stage, error feedback giving its inner compressor) and the two-level
  allgather against the reference's mesh (to 1e-6), no fallback on the
  2x2 topology, and ``process_stage_plan``;
* sparse slices, join, the process plane and the torch frontend against
  their numpy results, and the frontend's optimizers against plain
  ``torch.optim.SGD`` fed the job's averaged gradients, and the Adasum
  delta optimizer against ``numpy_adasum`` of the ranks' deltas.

A second job (task ``train_wire``) trains the MLP 2 steps with error
feedback over int8, two-level int8, hierarchical and hierarchical
Adasum reduction, held against the reference's ``make_train_step`` on
its mesh (losses and parameters to 1e-5, as the MLP's other parity
tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as hvd
from horovod_tpu import training as ref_training
from horovod_tpu.ops.adasum import numpy_adasum, numpy_hierarchical_adasum
from horovod_tpu.ops.compression import (
    Compression as RefCompression, numpy_error_feedback_reduce,
)
from horovod_tpu.optim import fused_update as ref_fu
from horovod_tpu.parallel import hierarchical as ref_hier
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_dist_worker import (
    FRONTEND_IN, FRONTEND_OUT, WIRE_SET, WIRE_SHAPES, WIRE_STEPS,
    WIRE_TRAIN, frontend_data, launch, wire_inputs,
)

WORLD, LOCAL = 4, 2


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("wire")
    launch("wire", WORLD, workdir, local_size=LOCAL)
    return [dict(np.load(workdir / f"wire.{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def inputs():
    return [wire_inputs(r) for r in range(WORLD)]


def _on_reference_mesh(fn, *per_rank):
    """``fn(*one rank's arrays)`` on the reference's 4-device CPU mesh
    (2 devices a host); every rank's output."""
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:WORLD], local_size=LOCAL)
    try:
        @hvd.spmd
        def run(*xs):
            return fn(*(x[0] for x in xs))[None]

        return [np.asarray(o) for o in hvd.get_per_rank(
            run(*(np.stack(a) for a in per_rank)))]
    finally:
        hvd.shutdown()


def _all_ranks(port, key):
    return [port[r][key] for r in range(WORLD)]


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leaf", range(len(WIRE_SHAPES)))
def test_ef_int8_matches_numpy_oracle_over_steps(port, inputs, leaf):
    grads = [inp[f"ef{leaf}"] for inp in inputs]
    res = [np.zeros_like(g, np.float64) for g in grads]
    for s in range(WIRE_STEPS):
        mean, res = numpy_error_feedback_reduce(grads, res, wire="int8")
        for r in range(WORLD):
            np.testing.assert_allclose(port[r][f"ef/{s}/mean{leaf}"], mean,
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(port[r][f"ef/{s}/res{leaf}"], res[r],
                                       rtol=1e-5, atol=1e-5)


def test_one_max_allreduce_per_call_and_fp8_refused_on_gloo(port):
    for r in range(WORLD):
        assert int(port[r]["ef/max_allreduces"]) == WIRE_STEPS
        assert bool(port[r]["ef/fp8_refused_on_gloo"])


# ---------------------------------------------------------------------------
# Adasum
# ---------------------------------------------------------------------------
def _bit_identical(outs):
    for o in outs[1:]:
        assert np.array_equal(o.view(np.uint32), outs[0].view(np.uint32))


def test_adasum_flat_matches_oracle_and_reference(port, inputs):
    vs = [inp["v"] for inp in inputs]
    outs = _all_ranks(port, "adasum/flat")
    _bit_identical(outs)
    np.testing.assert_allclose(outs[0], numpy_adasum(vs), rtol=1e-5,
                               atol=1e-5)
    ref = _on_reference_mesh(lambda v: hvd.allreduce(v, op=hvd.Adasum), vs)
    np.testing.assert_allclose(outs[0], ref[0], rtol=1e-5, atol=1e-5)


def test_adasum_hierarchical_matches_oracle_and_reference(port, inputs):
    vs = [inp["v"] for inp in inputs]
    outs = _all_ranks(port, "adasum/hier")
    _bit_identical(outs)
    np.testing.assert_allclose(outs[0], numpy_hierarchical_adasum(vs, LOCAL),
                               rtol=1e-5, atol=1e-5)
    ref = _on_reference_mesh(
        lambda v: hvd.allreduce(v, op=hvd.Adasum, hierarchical=True), vs)
    np.testing.assert_allclose(outs[0], ref[0], rtol=1e-5, atol=1e-5)


def test_adasum_process_set_members_and_pass_through(port, inputs):
    want = numpy_adasum([inputs[r]["v"] for r in WIRE_SET])
    members = [port[r]["adasum/set"] for r in WIRE_SET]
    _bit_identical(members)
    np.testing.assert_allclose(members[0], want, rtol=1e-5, atol=1e-5)
    for r in set(range(WORLD)) - set(WIRE_SET):
        np.testing.assert_array_equal(port[r]["adasum/set"], inputs[r]["v"])
    for r in (0, 1, 2):                      # the members of the set of 3
        assert bool(port[r]["adasum/odd_set_raises"])


# ---------------------------------------------------------------------------
# hierarchical and two-level reduction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key,ref_fn", [
    ("hier/average", lambda x: ref_hier.hierarchical_allreduce(x)),
    ("hier/sum", lambda x: ref_hier.hierarchical_allreduce(x, op=hvd.Sum)),
    ("hier/allreduce", lambda x: hvd.allreduce(x, hierarchical=True)),
    ("two_level/int8", lambda x: ref_hier.two_level_allreduce(
        x, compression=RefCompression.int8)),
    ("two_level/ef_int8", lambda x: hvd.allreduce(
        x, two_level=True, compression=RefCompression.lookup("ef_int8"))),
    ("two_level/sum", lambda x: ref_hier.two_level_allreduce(x, op=hvd.Sum)),
])
def test_hierarchical_reductions_match_reference_mesh(port, inputs, key,
                                                      ref_fn):
    ref = _on_reference_mesh(ref_fn, [inp["x"] for inp in inputs])
    for r in range(WORLD):
        np.testing.assert_allclose(port[r][key], ref[r], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{key} rank {r}")


def test_two_level_takes_no_fallback_and_plan_matches(port, inputs):
    xs = [inp["x"] for inp in inputs]
    for r in range(WORLD):
        assert int(port[r]["two_level/fallbacks"]) == 0
        np.testing.assert_array_equal(port[r]["hier/allgather"],
                                      np.stack(xs))
        plan = ref_hier.process_stage_plan(rank=r, size=WORLD,
                                           local_size=LOCAL)
        np.testing.assert_array_equal(port[r]["hier/plan"][0],
                                      [s.peers for s in plan])


# ---------------------------------------------------------------------------
# sparse slices, join, the process plane
# ---------------------------------------------------------------------------
def test_sparse_allgather_and_tree_residual(port, inputs):
    values = np.concatenate([inp["sv"] for inp in inputs]) / WORLD
    indices = np.concatenate([inp["si"] for inp in inputs])
    tree_w, _ = numpy_error_feedback_reduce(
        [inp["x"] for inp in inputs], [np.zeros(7)] * WORLD)
    for r in range(WORLD):
        np.testing.assert_allclose(port[r]["sparse/values"], values,
                                   rtol=1e-6)
        np.testing.assert_array_equal(port[r]["sparse/indices"], indices)
        np.testing.assert_allclose(port[r]["sparse/tree_values"], values,
                                   rtol=1e-6)
        np.testing.assert_allclose(port[r]["sparse/tree_w"], tree_w,
                                   rtol=1e-5, atol=1e-5)
        assert bool(port[r]["sparse/res_untouched"])


def test_join_divides_by_the_active_ranks(port, inputs):
    want = np.mean([inputs[r]["x"] for r in range(3)], axis=0)
    for r in range(WORLD):
        np.testing.assert_allclose(port[r]["join/average"], want, rtol=1e-6)
        assert int(port[r]["join/count"]) == 3


@pytest.mark.parametrize("key", ["eager/allreduce", "eager/allgather",
                                 "eager/broadcast", "eager/objects",
                                 "eager/object"])
def test_process_plane(port, inputs, key):
    xs = [inp["x"] for inp in inputs]
    want = {"eager/allreduce": np.mean(xs, axis=0),
            "eager/allgather": np.concatenate([i["g"] for i in inputs]),
            "eager/broadcast": xs[1],
            "eager/objects": np.arange(WORLD) * 10,
            "eager/object": np.asarray(2)}[key]
    for r in range(WORLD):
        np.testing.assert_allclose(port[r][key], want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the torch frontend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", ["frontend/sum", "frontend/average",
                                 "frontend/max", "frontend/fp16",
                                 "frontend/inplace_sum", "frontend/allgather",
                                 "frontend/broadcast", "frontend/object"])
def test_frontend_collectives(port, inputs, key):
    xs = np.stack([inp["x"] for inp in inputs])
    want, tol = {
        "frontend/sum": (xs.sum(0), 1e-6),
        "frontend/average": (xs.mean(0), 1e-6),
        "frontend/max": (xs.max(0), 0),
        # each rank's bf16 payload (8 bits of mantissa), summed
        "frontend/fp16": (xs.mean(0), 2e-2),
        "frontend/inplace_sum": (xs.sum(0), 1e-6),
        "frontend/allgather": (np.concatenate([i["g"] for i in inputs]), 0),
        "frontend/broadcast": (xs[1], 0),
        "frontend/object": (np.asarray(103), 0),
    }[key]
    for r in range(WORLD):
        np.testing.assert_allclose(port[r][key], want, rtol=tol, atol=tol)


def _frontend_oracle(name: str):
    """The frontend's training on plain torch: rank 0's initial model,
    SGD-momentum over the ranks' averaged gradients (two passes summed
    a step for bpps2), or, for Adasum, each rank's own local step from
    the shared start and numpy_adasum of the ranks' deltas."""
    data = [tuple(torch.from_numpy(a) for a in frontend_data(r))
            for r in range(WORLD)]

    def model_of_rank0():
        torch.manual_seed(0)
        return torch.nn.Linear(FRONTEND_IN, FRONTEND_OUT)

    if name == "adasum":
        models = [model_of_rank0() for _ in range(WORLD)]
        opts = [torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
                for m in models]
        for _ in range(2):
            start = [p.detach().clone() for p in models[0].parameters()]
            deltas = []
            for m, o, (x, y) in zip(models, opts, data):
                with torch.no_grad():
                    for p, s in zip(m.parameters(), start):
                        p.copy_(s)
                o.zero_grad()
                torch.nn.functional.mse_loss(m(x), y).backward()
                o.step()
                deltas.append([(p.detach() - s).numpy()
                               for p, s in zip(m.parameters(), start)])
            reduced = [numpy_adasum([d[i] for d in deltas])
                       for i in range(len(start))]
            with torch.no_grad():
                for m in models:
                    for p, s, d in zip(m.parameters(), start, reduced):
                        p.copy_(s + torch.from_numpy(d))
        return models[0]
    model = model_of_rank0()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    passes = 2 if name == "bpps2" else 1
    for _ in range(2):
        grads = []
        for x, y in data:
            model.zero_grad()
            for _ in range(passes):
                torch.nn.functional.mse_loss(model(x), y).backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        for i, p in enumerate(model.parameters()):
            p.grad = torch.stack([g[i] for g in grads]).mean(0)
        opt.step()
    return model


@pytest.mark.parametrize("name", ["sgd", "bpps2", "adasum"])
def test_frontend_optimizers_match_plain_torch(port, name):
    want = _frontend_oracle(name)
    for r in range(WORLD):
        np.testing.assert_allclose(port[r][f"train/{name}/weight"],
                                   want.weight.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(port[r][f"train/{name}/bias"],
                                   want.bias.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the train step with the wire tier's options, against the reference
# ---------------------------------------------------------------------------
def _mlp_problem():
    import flax.linen as nn

    class RefMLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.relu(nn.Dense(16)(x))
            return nn.Dense(6)(x)

    rng = np.random.default_rng(31)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    y = rng.integers(0, 6, size=(8,)).astype(np.int32)
    ref = RefMLP()
    variables = jax.tree_util.tree_map(
        np.asarray, ref.init(jax.random.PRNGKey(4), x))
    return ref, variables, x, y


def _reference_wire_run(ref, variables, x, y, comp, kw):
    import optax

    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:WORLD], local_size=LOCAL)
    try:
        opt = ref_fu.fused_sgd(0.1, momentum=0.9)
        compression = RefCompression.lookup(comp) if comp else None
        step = ref_training.make_train_step(
            apply_fn=lambda v, a, train=True: ref.apply(v, a),
            loss_fn=lambda lg, lb: optax.softmax_cross_entropy_with_integer_labels(
                lg, lb).mean(),
            optimizer=opt, compression=compression or RefCompression.none,
            loss_fetch_steps=0, **kw)
        params = variables["params"]
        residual = jax.tree_util.tree_map(jnp.zeros_like, params) \
            if comp and comp.startswith("ef_") else ()
        state = ref_training.TrainState(
            params=params, opt_state=opt.init(params), model_state={},
            step=jnp.zeros((), jnp.int32), residual=residual)
        state = jax.device_put(state, NamedSharding(hvd.core.mesh(), P()))
        xs, ys = ref_training.shard_batch(x), ref_training.shard_batch(y)
        losses = []
        for _ in range(2):
            state, loss = step(state, xs, ys)
            losses.append(float(jax.device_get(loss)))
        from horovod_tpu_torch.convert import flatten_flax

        return np.asarray(losses), flatten_flax(
            jax.tree_util.tree_map(np.asarray, state.params))
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def train_wire(tmp_path_factory):
    from horovod_tpu_torch.convert import flatten_flax

    ref, variables, x, y = _mlp_problem()
    params = flatten_flax(variables["params"])
    workdir = tmp_path_factory.mktemp("train_wire")
    np.savez(workdir / "inputs.npz", x=x, y=y, in_features=12,
             features=np.array([16, 6]),
             **{f"p:{k}": v for k, v in params.items()})
    launch("train_wire", WORLD, workdir, local_size=LOCAL)
    port = [dict(np.load(workdir / f"train_wire.{r}.npz"))
            for r in range(WORLD)]
    return ref, variables, x, y, params, port


@pytest.mark.parametrize("name", list(WIRE_TRAIN))
def test_train_step_with_wire_options_matches_reference(train_wire, name):
    ref, variables, x, y, params0, port = train_wire
    comp, kw = WIRE_TRAIN[name]
    want_losses, want = _reference_wire_run(ref, variables, x, y, comp, kw)
    for r in range(WORLD):
        got = port[r]
        np.testing.assert_allclose(got[f"{name}/losses"], want_losses,
                                   rtol=1e-5, atol=1e-5)
        for k, w in want.items():
            change = got[f"{name}/p:{k}"] - params0[k]
            np.testing.assert_allclose(
                change, w - params0[k], rtol=1e-5,
                atol=1e-5 * np.abs(w - params0[k]).max(),
                err_msg=f"{name} {k} rank {r}")
