"""horovod_tpu_torch.parallel.moe against horovod_tpu.parallel.moe.

``top1_dispatch`` is compared exactly with the reference's (the capacity
drop, 1024 bf16 tokens on one expert, random gates).  One 4-rank gloo
job (``tests/torch_dist_worker.py``, task ``moe``) runs ``moe_apply`` at
ep = 4 with 2 experts a rank, 16 tokens a rank, at capacity 4 (tokens
dropped) and 16 (none), and takes the gradients of ``sum(out · g)``.
The reference runs the same under ``shard_map`` on a 4-device CPU mesh;
the dense oracle routes each rank's tokens in numpy
(``tests/test_moe.py``'s ``_oracle``, float64).  Tolerances: 1e-5 against
the reference and the oracle (float32, sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.parallel import moe as ref_moe
from horovod_tpu_torch.convert import moe_params_from_flax
from horovod_tpu_torch.parallel import moe
from torch_dist_worker import (
    MOE_CAPACITIES, MOE_PER_RANK, launch, moe_expert_fn, moe_inputs,
)

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _both(gates: np.ndarray, capacity: int, jdtype, tdtype):
    with jax.default_device(jax.devices("cpu")[0]):
        ref = ref_moe.top1_dispatch(jnp.asarray(gates, jdtype), capacity)
        ref = [np.asarray(a.astype(jnp.float32)) for a in ref]
    ours = moe.top1_dispatch(torch.from_numpy(gates).to(tdtype), capacity)
    return ref, [a.float().numpy() for a in ours]


@pytest.mark.parametrize("case", ["capacity_drop", "bf16_1024_tokens",
                                  "random"])
def test_top1_dispatch_equals_reference(case):
    if case == "capacity_drop":
        gates = np.asarray([[0.9, 0.1], [0.8, 0.2], [0.7, 0.3], [0.2, 0.8]],
                           np.float32)
        ref, ours = _both(gates, 2, jnp.float32, torch.float32)
        assert ours[0][2].sum() == 0.0           # token 2 over capacity
    elif case == "bf16_1024_tokens":
        # every token on expert 0: positions past 256 must not collide
        # (a bf16 cumsum would saturate; positions are int32)
        gates = np.tile(np.asarray([[0.9, 0.5]], np.float32), (1024, 1))
        ref, ours = _both(gates, 1024, jnp.bfloat16, torch.bfloat16)
        assert (ours[0].sum(axis=0)[0] == 1.0).all()   # one token a slot
    else:
        gates = np.random.default_rng(8).dirichlet(np.ones(6), 50).astype(
            np.float32)
        ref, ours = _both(gates, 5, jnp.float32, torch.float32)
    for got, want in zip(ours, ref):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("moe")
    launch("moe", WORLD, workdir, timeout=90)
    return [dict(np.load(workdir / f"moe.{r}.npz")) for r in range(WORLD)]


def _reference(inp, capacity):
    """``moe_apply`` under shard_map on the reference's 4-device mesh:
    every rank's output and the gradients of its ``sum(out · g)`` (with
    the all_to_all transposes carrying the other ranks' cotangents to
    each rank's experts)."""
    devs = jax.devices("cpu")[:WORLD]
    mesh = Mesh(np.array(devs), ("ep",))

    def body(w, v, router, x, g):
        def loss_of(w, v, router, x):
            out = ref_moe.moe_apply(
                lambda p, t: jnp.tanh(t @ p["w"]) @ p["v"],
                {"w": w, "v": v}, x[0], router, capacity=capacity, axis="ep")
            return (out * g[0]).sum(), out

        (_, out), grads = jax.value_and_grad(
            loss_of, argnums=(0, 1, 2, 3), has_aux=True)(w, v, router, x)
        dw, dv, dr, dx = grads
        return out[None], dw, dv, dr[None], dx

    spec = P("ep")
    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(spec, spec, P(), spec, spec),
                               out_specs=(spec,) * 5, check_vma=False))
    with jax.default_device(devs[0]):
        args = [jax.device_put(jnp.asarray(inp[k]), NamedSharding(
            mesh, P() if k == "router" else spec))
            for k in ("w", "v", "router", "x", "g")]
        return [np.asarray(a) for a in fn(*args)]


def _oracle(inp, r, capacity):
    """Rank r's tokens routed in numpy, float64: argmax expert, slots
    counted in token order, past the capacity dropped, the expert's
    output weighted by the gate."""
    x = inp["x"][r].astype(np.float64)
    logits = x @ inp["router"].astype(np.float64)
    g = np.exp(logits - logits.max(-1, keepdims=True))
    gates = g / g.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    counts = np.zeros(gates.shape[1], np.int64)
    for t in range(x.shape[0]):
        e = int(np.argmax(gates[t]))
        if counts[e] >= capacity:
            continue
        counts[e] += 1
        p = {k: inp[k][e].astype(np.float64) for k in ("w", "v")}
        out[t] = moe_expert_fn(p, x[t][None])[0] * gates[t, e]
    return out


@pytest.mark.parametrize("capacity", MOE_CAPACITIES)
def test_moe_apply_matches_reference_and_oracle(port_results, capacity):
    inp = moe_inputs(WORLD)
    out, dw, dv, drouter, dx = _reference(inp, capacity)
    for r, res in enumerate(port_results):
        mine = slice(r * MOE_PER_RANK, (r + 1) * MOE_PER_RANK)
        np.testing.assert_allclose(res[f"{capacity}/out"], out[r], **TOL)
        np.testing.assert_allclose(res[f"{capacity}/out"],
                                   _oracle(inp, r, capacity), **TOL)
        for name, want in (("dw", dw[mine]), ("dv", dv[mine]),
                           ("drouter", drouter[r]), ("dx", dx[r])):
            np.testing.assert_allclose(res[f"{capacity}/{name}"], want,
                                       err_msg=f"{name} of rank {r}", **TOL)


def test_experts_must_divide_over_the_ranks(port_results):
    """3 experts over 4 ranks raises on every rank, before any exchange."""
    assert all(bool(res["indivisible_error"]) for res in port_results)


def test_drops_happen_at_the_small_capacity(port_results):
    """Capacity 4 drops tokens (zero rows), capacity 16 none."""
    small = np.concatenate([res["4/out"] for res in port_results])
    whole = np.concatenate([res["16/out"] for res in port_results])
    assert (np.abs(small).sum(-1) == 0).any()
    assert not (np.abs(whole).sum(-1) == 0).any()


def test_one_rank_holds_every_expert():
    """ep = 1 (a group of one, as on one card): every expert local, the
    exchange the identity; equals the oracle."""
    from horovod_tpu_torch import core

    core.shutdown()
    core.init(device="cpu")
    try:
        inp = moe_inputs(1)
        p = moe_params_from_flax({"experts": {"w": inp["w"], "v": inp["v"]},
                                  "router": inp["router"]})
        out = moe.moe_apply(moe_expert_fn, p["experts"],
                            torch.from_numpy(inp["x"][0]), p["router"],
                            capacity=16, axis=None)
        np.testing.assert_allclose(out.numpy(), _oracle(inp, 0, 16), **TOL)
    finally:
        core.shutdown()


def test_converter_slices_this_ranks_experts():
    inp = moe_inputs(WORLD)
    params = {"experts": {"w": inp["w"], "v": inp["v"]},
              "router": inp["router"]}
    for r in range(WORLD):
        p = moe_params_from_flax(params, rank=r, ep=WORLD)
        mine = slice(r * MOE_PER_RANK, (r + 1) * MOE_PER_RANK)
        np.testing.assert_array_equal(p["experts"]["w"].numpy(),
                                      inp["w"][mine])
        np.testing.assert_array_equal(p["router"].numpy(), inp["router"])
