"""horovod_tpu_torch.parallel.pipeline against
horovod_tpu.parallel.pipeline and the sequential stack.

One 4-rank gloo job (``tests/torch_dist_worker.py``, task ``pp``) runs
a 4-stage pipeline of ``tanh(x·w + b)`` stages over the world (6
microbatches of 2 rows), then a (dp, pp) = (2, 2) mesh, each dp row its
own microbatches; each rank takes the gradients of ``sum(out · g)`` of
its stage's parameters and of the microbatches.  The oracle is the
stages applied one after another in this process; the reference runs
``pipeline_apply`` under ``shard_map(check_vma=True)`` on a 4-device
CPU mesh.  The gradients equal the sequential stack's: the final sum's
backward is the identity, where a plain all-reduce backward would scale
them by S.  Tolerance 1e-5 (float32, the same products in the same
order, but the microbatch gradients summed across ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.parallel import pipeline as ref_pp
from horovod_tpu_torch.convert import pipeline_params_from_flax
from horovod_tpu_torch.parallel import pipeline as pp
from torch_dist_worker import PP_STAGES, launch, pp_inputs, pp_stage_fn

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("pp")
    launch("pp", WORLD, workdir, timeout=90)
    return [dict(np.load(workdir / f"pp.{r}.npz")) for r in range(WORLD)]


def _sequential(inp, stages, row=0):
    """The stages one after another on each microbatch (torch, here):
    the outputs and the gradients of ``sum(out · g)``."""
    ps = [{n: torch.from_numpy(inp[f"{n}{i}"]).requires_grad_()
           for n in ("w", "b")} for i in range(stages)]
    x = torch.from_numpy(inp["x"][row]).requires_grad_()
    h = x
    for p in ps:
        h = pp_stage_fn(p, h)
    (h * torch.from_numpy(inp["g"][row])).sum().backward()
    return {"out": h.detach().numpy(), "dx": x.grad.numpy(),
            "dw": [p["w"].grad.numpy() for p in ps],
            "db": [p["b"].grad.numpy() for p in ps]}


def _reference(inp):
    """``pipeline_apply`` on the reference's 4-device mesh: the outputs
    and the gradients of ``sum(out · g)`` (stage parameters, x)."""
    devs = jax.devices("cpu")[:PP_STAGES]
    mesh = Mesh(np.array(devs), ("pp",))
    stacked = ref_pp.stack_stage_params([
        {n: jnp.asarray(inp[f"{n}{i}"]) for n in ("w", "b")}
        for i in range(PP_STAGES)])

    def body(params_stack, x, g):
        mine = jax.tree_util.tree_map(lambda a: a[0], params_stack)

        def loss_of(p, x):
            out = ref_pp.pipeline_apply(
                lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), p, x, axis="pp")
            return (out * g).sum(), out

        (_, out), (gp, gx) = jax.value_and_grad(loss_of, argnums=(0, 1),
                                                has_aux=True)(mine, x)
        return out, jax.tree_util.tree_map(lambda a: a[None], gp), gx

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("pp"), P(), P()),
                               out_specs=(P(), P("pp"), P()),
                               check_vma=True))
    with jax.default_device(devs[0]):
        params = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, NamedSharding(mesh, P("pp"))),
            stacked)
        out, gp, gx = fn(params, jnp.asarray(inp["x"][0]),
                         jnp.asarray(inp["g"][0]))
    return {"out": np.asarray(out), "dx": np.asarray(gx),
            "dw": np.asarray(gp["w"]), "db": np.asarray(gp["b"])}


def test_pipeline_matches_sequential_and_reference(port_results):
    inp = pp_inputs()
    want = _sequential(inp, PP_STAGES)
    ref = _reference(inp)
    for r, res in enumerate(port_results):
        np.testing.assert_allclose(res["pp/out"], want["out"], **TOL)
        np.testing.assert_allclose(res["pp/out"], ref["out"], **TOL)
        # each rank holds exactly its own stage's gradient, no factor S
        for n in ("dw", "db"):
            np.testing.assert_allclose(res[f"pp/{n}"], want[n][r],
                                       err_msg=f"{n} of stage {r}", **TOL)
            np.testing.assert_allclose(res[f"pp/{n}"], ref[n][r],
                                       err_msg=f"{n} of stage {r}", **TOL)
    # x enters at rank 0 alone; its gradient over the ranks is the stack's
    dx = sum(res["pp/dx"] for res in port_results)
    np.testing.assert_allclose(dx, want["dx"], **TOL)
    np.testing.assert_allclose(dx, ref["dx"], **TOL)


def test_dp_pp_rows_match_their_sequential_stacks(port_results):
    """(dp, pp) = (2, 2): rank 2·row + stage; each dp row's outputs and
    its stages' gradients are its own microbatches' sequential ones."""
    inp = pp_inputs(2, 2)
    for row in range(2):
        want = _sequential(inp, 2, row)
        for stage in range(2):
            res = port_results[2 * row + stage]
            np.testing.assert_allclose(res["dp_pp/out"], want["out"], **TOL)
            for n in ("dw", "db"):
                np.testing.assert_allclose(res[f"dp_pp/{n}"],
                                           want[n][stage], **TOL)


def test_one_stage_is_the_stage():
    """S = 1 (a group of one, as on one card): the pipeline is its stage
    on every microbatch, outputs and gradients."""
    from horovod_tpu_torch import core

    core.shutdown()
    core.init(device="cpu")
    try:
        inp = pp_inputs(1, 1)
        want = _sequential(inp, 1)
        p = {n: torch.from_numpy(inp[f"{n}0"]).requires_grad_()
             for n in ("w", "b")}
        out = pp.pipeline_apply(pp_stage_fn, p, torch.from_numpy(
            inp["x"][0]), axis=None)
        (out * torch.from_numpy(inp["g"][0])).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), want["out"], **TOL)
        np.testing.assert_allclose(p["w"].grad.numpy(), want["dw"][0], **TOL)
    finally:
        core.shutdown()


def test_stacking_and_the_converter_match_the_reference():
    """``stack_stage_params`` as the reference's, and
    ``pipeline_params_from_flax`` of per-stage dicts or their stack."""
    inp = pp_inputs()
    stages = [{n: inp[f"{n}{i}"] for n in ("w", "b")}
              for i in range(PP_STAGES)]
    with jax.default_device(jax.devices("cpu")[0]):
        ref = ref_pp.stack_stage_params(
            [{k: jnp.asarray(v) for k, v in s.items()} for s in stages])
    ours = pp.stack_stage_params([{k: torch.from_numpy(v)
                                   for k, v in s.items()} for s in stages])
    for conv in (pipeline_params_from_flax(stages),
                 pipeline_params_from_flax(jax.device_get(ref)), ours):
        assert set(conv) == {"w", "b"}
        for k in conv:
            np.testing.assert_array_equal(conv[k].numpy(),
                                          np.asarray(ref[k]))
