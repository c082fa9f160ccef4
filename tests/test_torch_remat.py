"""make_train_step's ``remat_policy`` against the reference's.

The port checkpoints the loss closure with ``torch.utils.checkpoint``
(``full``: the backward recomputes the whole forward; ``dots``: it keeps
the matrix products' outputs, as JAX's ``checkpoint_dots`` keeps
``dot_general``).  Held against the reference's
``make_train_step(remat_policy=...)`` on the trajectories the no-remat
tests of tests/test_torch_training.py use, at their tolerances: the MLP
in float32 (1e-5) and the narrow ResNet-18 in float64 (1e-6).

The recomputed forward would update the BatchNorm running statistics a
second time; the reference returns them once, as the forward's aux.  So
the port's statistics with remat must equal its statistics without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models.resnet import ResNet18 as RefResNet18
from horovod_tpu_torch import core, training
from horovod_tpu_torch.convert import flatten_flax, load_flax_variables
from horovod_tpu_torch.models import MLP, ResNet18
from horovod_tpu_torch.optim.fused_update import fused_sgd
from test_torch_training import (
    _assert_trajectories_match, _mlp_problem, _port_run, _reference_run,
    _resnet_variables,
)

POLICIES = ["full", "dots"]


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE", "HVD_REMAT_POLICY"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_mlp_trajectory_matches_reference(port_cpu_world, policy):
    ref, variables, x, y = _mlp_problem()
    want = _reference_run(ref, variables, x, y, ndev=1, fused=True,
                          batch_stats=False, remat_policy=policy)
    model = MLP(12, (16, 6))
    load_flax_variables(model, variables["params"])
    got = _port_run(model, x, y, fused=True, batch_stats=False,
                    remat_policy=policy)
    _assert_trajectories_match(got, want, flatten_flax(variables["params"]),
                               1e-5)


def _resnet_problem():
    rng = np.random.default_rng(31)
    x = rng.uniform(size=(4, 64, 64, 3))
    y = rng.integers(0, 10, size=(4,)).astype(np.int32)
    return x, y, _resnet_variables(RefResNet18, x.astype(np.float32))


def _port_resnet(variables, x, y, policy):
    model = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    return _port_run(model.double(), x, y, fused=True, batch_stats=True,
                     remat_policy=policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_resnet18_trajectory_matches_reference_float64(
        port_cpu_world, policy):
    x, y, variables = _resnet_problem()
    with jax.enable_x64(True):
        ref = RefResNet18(num_classes=10, num_filters=8, dtype=jnp.float64,
                          param_dtype=jnp.float64)
        want = _reference_run(ref, variables, x, y, ndev=1, fused=True,
                              batch_stats=True, remat_policy=policy)
    got = _port_resnet(variables, x, y, policy)
    _assert_trajectories_match(got, want, flatten_flax(variables["params"]),
                               1e-6)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_updates_batchnorm_statistics_once(port_cpu_world, policy):
    """With remat, the step's BatchNorm statistics and parameters equal
    those of the same step without: the recompute's second update of
    the running statistics is undone."""
    x, y, variables = _resnet_problem()
    plain = _port_resnet(variables, x, y, None)
    remat = _port_resnet(variables, x, y, policy)
    assert list(remat[2]) == list(plain[2]) and plain[2]
    for k in plain[2]:
        np.testing.assert_array_equal(remat[2][k], plain[2][k], err_msg=k)
    np.testing.assert_array_equal(remat[0], plain[0])
    for k in plain[1]:
        np.testing.assert_allclose(remat[1][k], plain[1][k], rtol=1e-12,
                                   atol=1e-12, err_msg=k)


def test_remat_policy_env_reaches_the_step(port_cpu_world, monkeypatch):
    """``HVD_REMAT_POLICY=full`` with no argument checkpoints the loss
    closure once a step."""
    import torch.utils.checkpoint as ckpt

    calls = []
    original = ckpt.checkpoint

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return original(*args, **kwargs)

    monkeypatch.setattr(ckpt, "checkpoint", counting)
    monkeypatch.setenv("HVD_REMAT_POLICY", "full")
    _, variables, x, y = _mlp_problem()
    model = MLP(12, (16, 6))
    load_flax_variables(model, variables["params"])
    _port_run(model, x, y, fused=True, batch_stats=False)
    assert len(calls) == 3
    assert all(not c["use_reentrant"] and not c["preserve_rng_state"]
               for c in calls)


@pytest.mark.parametrize("kw,env", [({"remat_policy": "offload"}, {}),
                                    ({}, {"HVD_REMAT_POLICY": "everything"})])
def test_unknown_remat_policy_raises(monkeypatch, kw, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="unknown remat policy"):
        training.make_train_step(apply_fn=MLP(4), loss_fn=F.cross_entropy,
                                 optimizer=fused_sgd(0.1), **kw)
