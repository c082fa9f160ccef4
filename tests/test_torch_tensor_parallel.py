"""horovod_tpu_torch.parallel.tensor_parallel against
horovod_tpu.parallel.tensor_parallel.

One 4-rank gloo job (``tests/torch_dist_worker.py``, task ``tp``) on a
(dp, tp) = (2, 2) mesh trains a float32 ``ParallelMLP`` 3 SGD steps
from the reference's initial weights: at tp = 2 on the whole batch (each
dp row alone), then at dp × tp = 2 × 2 (the rows split the batch and
average their gradients); and slices and gathers an activation with
``tp_constraint``.  The reference trains the same with GSPMD on (1, 2)
and (2, 2) CPU meshes; the unsharded oracle is the port's ``ParallelMLP``
whole, in this process.  Tolerance 1e-5 (float32 sums in other orders:
the partitioned products and the all-reduce's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.parallel import tensor_parallel as ref_tp
from horovod_tpu_torch.convert import (
    canonical_params, flatten_flax, load_flax_variables,
    parallel_mlp_params_from_flax, to_flax_layout,
)
from horovod_tpu_torch.models.bert import SelfAttention
from horovod_tpu_torch.parallel import tensor_parallel as tp
from torch_dist_worker import (
    TP_HIDDEN, TP_IN, TP_LR, TP_OUT, TP_STEPS, launch, nested_flax,
    tp_inputs,
)

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def flax_params():
    """The reference's initial ParallelMLP parameters, the zero biases
    redrawn so that a misplaced bias shows."""
    model = ref_tp.ParallelMLP(hidden=TP_HIDDEN, out=TP_OUT,
                               dtype=jnp.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        params = model.init(jax.random.PRNGKey(0),
                            jnp.zeros((2, TP_IN)))["params"]
    flat = flatten_flax(params)
    rng = np.random.default_rng(3)
    for k in ("up/bias", "down/bias"):
        flat[k] = (0.1 * rng.normal(size=flat[k].shape)).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def port_results(tmp_path_factory, flax_params):
    workdir = tmp_path_factory.mktemp("tp")
    np.savez(workdir / "inputs.npz",
             **{f"p:{k}": v for k, v in flax_params.items()})
    launch("tp", WORLD, workdir, timeout=90)
    return [dict(np.load(workdir / f"tp.{r}.npz")) for r in range(WORLD)]


def _reference_train(flax_params, dp):
    """TP_STEPS SGD steps under GSPMD on a (dp, 2) mesh: the losses and
    the final parameters (flax layout)."""
    devs = jax.devices("cpu")
    mesh = Mesh(np.array(devs[:2 * dp]).reshape(dp, 2), ("dp", "tp"))
    model = ref_tp.ParallelMLP(hidden=TP_HIDDEN, out=TP_OUT,
                               dtype=jnp.float32)
    data = tp_inputs()
    with jax.default_device(devs[0]):
        params = ref_tp.shard_tp_params(nested_flax(flax_params), mesh,
                                        rules=ref_tp.TP_MLP_RULES)
        x = jax.device_put(data["x"], NamedSharding(mesh, P("dp")))
        y = jax.device_put(data["y"], NamedSharding(mesh, P("dp")))

        @jax.jit
        def train(p, x, y):
            def loss_fn(p):
                return jnp.mean((model.apply({"params": p}, x) - y) ** 2)

            loss, g = jax.value_and_grad(loss_fn)(p)
            return loss, jax.tree_util.tree_map(lambda a, b: a - TP_LR * b,
                                                p, g)

        losses = []
        for _ in range(TP_STEPS):
            loss, params = train(params, x, y)
            losses.append(float(loss))
    return np.asarray(losses), flatten_flax(jax.device_get(params))


def _unsharded_train(flax_params):
    """The port's ParallelMLP whole (no tp), TP_STEPS steps here."""
    model = tp.ParallelMLP(TP_IN, TP_HIDDEN, TP_OUT, dtype=torch.float32)
    load_flax_variables(model, nested_flax(flax_params))
    data = tp_inputs()
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    params = canonical_params(model)
    losses = []
    for _ in range(TP_STEPS):
        loss = torch.mean((model(x) - y) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for t, g in zip(params.values(), grads):
                t -= TP_LR * g
        losses.append(loss.item())
    return np.asarray(losses), {k: to_flax_layout(t.detach().numpy())
                                for k, t in params.items()}


def _assembled(results, case, row):
    """A dp row's two tp shards as the whole MLP, flax layout."""
    a, b = results[2 * row], results[2 * row + 1]
    cat = {"up/kernel": 0, "up/bias": 0, "down/kernel": 1}
    out = {}
    for k in ("up/kernel", "up/bias", "down/kernel", "down/bias"):
        pa, pb = a[f"{case}/p:{k}"], b[f"{case}/p:{k}"]
        if k in cat:
            out[k] = to_flax_layout(np.concatenate([pa, pb], cat[k]))
        else:
            np.testing.assert_array_equal(pa, pb)   # replicated over tp
            out[k] = pa
    return out


@pytest.mark.parametrize("case,dp", [("tp", 1), ("dp_tp", 2)])
def test_training_matches_reference_and_unsharded(port_results, flax_params,
                                                  case, dp):
    want_losses, want = _reference_train(flax_params, dp)
    oracle_losses, oracle = _unsharded_train(flax_params)
    np.testing.assert_allclose(oracle_losses, want_losses, **TOL)
    for row in range(2):
        for r in (2 * row, 2 * row + 1):
            np.testing.assert_allclose(port_results[r][f"{case}/losses"],
                                       want_losses, **TOL)
        got = _assembled(port_results, case, row)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
            np.testing.assert_allclose(got[k], oracle[k], err_msg=k, **TOL)


def test_tp_constraint_slices_gathers_and_differentiates(port_results):
    """(None, "tp") from replicated: this rank's column block; back to
    replicated: the whole; the gradient of ``sum(back · w)`` is w."""
    data = tp_inputs()
    for r, res in enumerate(port_results):
        col = r % 2
        np.testing.assert_array_equal(res["constraint/block"],
                                      data["full"][:, col * 4:col * 4 + 4])
        np.testing.assert_array_equal(res["constraint/back"], data["full"])
        np.testing.assert_array_equal(res["constraint/grad"], data["w"])


def test_mlp_rules_name_every_parameter():
    model = tp.ParallelMLP(TP_IN, TP_HIDDEN, TP_OUT)
    assert set(canonical_params(model)) == set(tp.TP_MLP_RULES)
    assert set(tp.TP_MLP_RULES) == set(ref_tp.TP_MLP_RULES)


def test_attention_rules_name_every_projection():
    """Every parameter of the port's attention has a rule, and each rule
    names one; query/key/value shard whole heads (column parallel), the
    output projection its input's heads (row parallel)."""
    h, d = 4, 32
    attn = SelfAttention(d, h, dtype=torch.float32)
    names = set(canonical_params(attn))
    assert names == set(tp.TP_ATTENTION_RULES)
    assert set(tp.TP_ATTENTION_RULES) == set(ref_tp.TP_ATTENTION_RULES)
    params = canonical_params(attn)
    hd = d // h
    for r in range(2):
        for name in ("query", "key", "value"):
            w = tp.shard_leaf(params[f"{name}/kernel"], tp.spec_for(
                f"{name}/kernel", tp.TP_ATTENTION_RULES, "tp"), r, 2)
            heads = params[f"{name}/kernel"].reshape(h, hd, d)
            assert torch.equal(w.reshape(h // 2, hd, d),
                               heads[r * h // 2:(r + 1) * h // 2])
        w = tp.shard_leaf(params["out/kernel"], tp.spec_for(
            "out/kernel", tp.TP_ATTENTION_RULES, "tp"), r, 2)
        assert torch.equal(w, params["out/kernel"].reshape(d, h, hd)[
            :, r * h // 2:(r + 1) * h // 2].reshape(d, d // 2))
        bias = tp.spec_for("out/bias", tp.TP_ATTENTION_RULES, "tp")
        assert tp.shard_leaf(params["out/bias"], bias, r, 2).shape == (d,)


def test_converter_whole_and_sharded(flax_params):
    """``parallel_mlp_params_from_flax``: whole, the module's own
    load_flax_variables; by rank, the blocks of the whole."""
    model = tp.ParallelMLP(TP_IN, TP_HIDDEN, TP_OUT, dtype=torch.float32)
    load_flax_variables(model, nested_flax(flax_params))
    whole = parallel_mlp_params_from_flax(flax_params)
    for k, t in canonical_params(model).items():
        assert torch.equal(whole[k], t)
    shards = [parallel_mlp_params_from_flax(flax_params, rank=r, size=2)
              for r in range(2)]
    for k, dim in (("up/kernel", 0), ("up/bias", 0), ("down/kernel", 1)):
        assert torch.equal(torch.cat([s[k] for s in shards], dim), whole[k])
    assert torch.equal(shards[1]["down/bias"], whole["down/bias"])
    with pytest.raises(ValueError, match="not divisible"):
        parallel_mlp_params_from_flax(flax_params, rank=0, size=3)


def test_one_rank_is_the_whole_mlp(flax_params):
    """At tp = 1 (a group of one) f and g are the identity and the shard
    is the whole: the output equals the unsharded module's to float32
    rounding (the bias is added after the product, not inside it)."""
    from horovod_tpu_torch import core

    core.shutdown()
    core.init(device="cpu")
    try:
        x = torch.from_numpy(tp_inputs()["x"])
        whole = tp.ParallelMLP(TP_IN, TP_HIDDEN, TP_OUT, dtype=torch.float32)
        load_flax_variables(whole, nested_flax(flax_params))
        one = tp.ParallelMLP(TP_IN, TP_HIDDEN, TP_OUT, dtype=torch.float32,
                             axis=torch.distributed.group.WORLD)
        with torch.no_grad():
            for k, t in canonical_params(one).items():
                t.copy_(canonical_params(whole)[k])
        # the bias added after the product instead of inside it
        np.testing.assert_allclose(one(x).detach().numpy(),
                                   whole(x).detach().numpy(), **TOL)
    finally:
        core.shutdown()
