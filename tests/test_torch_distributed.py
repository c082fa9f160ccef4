"""horovod_tpu_torch.optim.distributed against
horovod_tpu.optim.distributed.

The reference's DistributedOptimizer runs on a 1-device CPU mesh, the
port's in a 1-rank CPU world (gloo), on the same seeded gradients, so
both reduce over one rank and a quantizer keeps the same headroom: the
parameters after each run (optax's ``sgd(0.1, momentum=0.9)`` and its
port) and, with error feedback, the residual in the optimizer's state,
to 1e-6 (float32 in both).  Cases: Average; ``backward_passes_per_step``
2 over 4 updates (zero updates in between); error feedback over int8,
alone and with 2 passes; Adasum; sparse gradients through the allgather
path and densified first.  Then the gradient tape, ``grad`` and the
broadcasts at one rank.  Across ranks the wrapper's reduction is
``allreduce_pytree``'s, held in ``tests/test_torch_wire.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.ops import compression as ref_comp
from horovod_tpu.ops import sparse as ref_sparse
from horovod_tpu.optim import distributed as ref
from horovod_tpu_torch import core
from horovod_tpu_torch.ops import compression as port_comp
from horovod_tpu_torch.ops import sparse as port_sparse
from horovod_tpu_torch.optim import distributed as port
from horovod_tpu_torch.optim import transforms
from horovod_tpu_torch.optim.fused_update import apply_updates


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def _problem(steps: int, sparse: bool = False):
    rng = np.random.default_rng(17 + steps)
    params = {"b": rng.normal(size=(3,)).astype(np.float32),
              "w": rng.normal(size=(4, 3)).astype(np.float32)}
    grads = []
    for _ in range(steps):
        g = {"b": rng.normal(size=(3,)).astype(np.float32),
             "w": rng.normal(size=(4, 3)).astype(np.float32)}
        if sparse:
            params["emb"] = np.zeros((6, 3), np.float32)
            g["emb"] = (rng.normal(size=(4, 3)).astype(np.float32),
                        rng.integers(0, 6, size=(4,)).astype(np.int32))
        grads.append(g)
    return params, grads


def _ref_run(params, grads, **kw):
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        opt = ref.DistributedOptimizer(optax.sgd(0.1, momentum=0.9), **kw)

        def as_ref(g):
            return {k: ref_sparse.IndexedSlices(jnp.asarray(v[0]),
                                                jnp.asarray(v[1]), (6, 3))
                    if isinstance(v, tuple) else v for k, v in g.items()}

        @hvd.spmd(in_specs=(P(), P()), out_specs=P())
        def run(p, gs):
            state = opt.init(p)
            for g in gs:
                u, state = opt.update(as_ref(g), state, p)
                p = optax.apply_updates(p, u)
            res = getattr(state, "residual", None)
            if res is None and hasattr(state, "inner"):
                res = getattr(state.inner, "residual", None)
            return p, res if res is not None else {}

        p, res = run(params, grads)
        return jax.tree_util.tree_map(np.asarray, (p, res))
    finally:
        hvd.shutdown()


def _port_run(params, grads, **kw):
    opt = port.DistributedOptimizer(transforms.sgd(0.1, momentum=0.9), **kw)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        g = {k: port_sparse.IndexedSlices(torch.from_numpy(v[0]),
                                          torch.from_numpy(v[1]), (6, 3))
             if isinstance(v, tuple) else torch.from_numpy(v)
             for k, v in g.items()}
        u, state = opt.update(g, state, p)
        apply_updates(p, u)
    res = getattr(state, "residual", None)
    if res is None and hasattr(state, "inner"):
        res = getattr(state.inner, "residual", None)
    return ({k: v.numpy() for k, v in p.items()},
            {k: v.numpy() for k, v in (res or {}).items()})


CASES = {
    "average": (3, {}, {}),
    "bpps2": (4, {"backward_passes_per_step": 2},
              {"backward_passes_per_step": 2}),
    "ef_int8": (3, {"compression": ref_comp.ErrorFeedback(
        ref_comp.Int8Compressor)}, {"compression": port_comp.ErrorFeedback(
            port_comp.Int8Compressor)}),
    "ef_int8_bpps2": (4, {"compression": ref_comp.ErrorFeedback(
        ref_comp.Int8Compressor), "backward_passes_per_step": 2},
        {"compression": port_comp.ErrorFeedback(port_comp.Int8Compressor),
         "backward_passes_per_step": 2}),
    "bf16": (2, {"compression": ref_comp.Compression.bf16},
             {"compression": port_comp.Compression.bf16}),
    "adasum": (2, {"op": hvd.Adasum}, {"op": "Adasum"}),
    "sparse": (2, {}, {}),
    "sparse_as_dense": (2, {"sparse_as_dense": True},
                        {"sparse_as_dense": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_distributed_optimizer_matches_reference(port_cpu_world, case):
    steps, ref_kw, port_kw = CASES[case]
    params, grads = _problem(steps, sparse=case.startswith("sparse"))
    want_p, want_res = _ref_run(params, grads, **ref_kw)
    got_p, got_res = _port_run(params, grads, **port_kw)
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert sorted(got_res) == sorted(want_res)
    for k in want_res:
        np.testing.assert_allclose(got_res[k], want_res[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_error_feedback_refuses_adasum():
    with pytest.raises(ValueError, match="not Adasum"):
        port.DistributedOptimizer(
            transforms.sgd(0.1),
            compression=port_comp.ErrorFeedback(port_comp.Int8Compressor),
            op="Adasum")
    with pytest.raises(ValueError, match=">= 1"):
        port.DistributedOptimizer(transforms.sgd(0.1),
                                  backward_passes_per_step=0)


def test_gradient_tape_and_grad(port_cpu_world):
    w = torch.tensor([1.0, -2.0, 0.5])
    x = torch.tensor([0.5, 2.0, -1.0])

    def loss(p, x):
        return torch.sum(p["w"] ** 2 * x)

    tape = port.DistributedGradientTape(port._local_grad(loss))
    g = tape.gradient({"w": w}, x)
    np.testing.assert_allclose(g["w"], (2 * w * x).numpy(), rtol=1e-6)
    g2 = port.grad(loss)({"w": w}, x)
    np.testing.assert_allclose(g2["w"], (2 * w * x).numpy(), rtol=1e-6)
    assert not w.requires_grad


def test_broadcasts_at_one_rank_leave_the_tree(port_cpu_world):
    params = {"w": torch.ones(3), "n": 4}
    assert port.broadcast_parameters(params) is params
    state = transforms.adam(1e-3).init({"w": torch.ones(3)})
    assert port.broadcast_optimizer_state(state) is state
    assert port.broadcast_variables(params)["w"].tolist() == [1.0] * 3
