"""horovod_tpu_torch.core against horovod_tpu.core: the rank / size /
local / cross layout for a world of 1, for a 2-process gloo world from
the launcher's identity env, and for a 4-process world with 2 per host
against the reference's SPMD rank math on a 4-device (cross 2, local 2)
mesh."""

import json

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu_torch import core
from torch_dist_worker import launch

LAYOUT = ("rank", "size", "local_rank", "local_size", "cross_rank",
          "cross_size")


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield core
    core.shutdown()


def test_world_of_one_matches_reference(port_cpu_world):
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        ref = {k: int(getattr(hvd, k)()) for k in LAYOUT}
    finally:
        hvd.shutdown()
    ours = {k: getattr(core, k)() for k in LAYOUT}
    assert ours == ref == {"rank": 0, "size": 1, "local_rank": 0,
                           "local_size": 1, "cross_rank": 0,
                           "cross_size": 1}
    assert core.device().type == "cpu"
    assert core.backend() == "gloo"


def test_init_is_idempotent_and_shutdown_resets(port_cpu_world):
    dev = core.device()
    core.init(device="cpu")
    assert core.device() == dev
    core.shutdown()
    with pytest.raises(core.NotInitializedError):
        core.rank()


def test_capability_probes(port_cpu_world):
    import torch

    assert core.gloo_built() and core.gloo_enabled()
    assert core.nccl_built() == torch.cuda.is_available()
    assert core.cuda_built() == torch.backends.cuda.is_built()
    assert not core.xla_built() and not core.mpi_enabled()


@pytest.mark.parametrize("env,err", [
    ({"HVD_NUM_PROCESSES": "2", "HVD_PROCESS_ID": "0"}, RuntimeError),
    ({"HVD_NUM_PROCESSES": "2", "HVD_PROCESS_ID": "2"}, ValueError),
    ({"HVD_NUM_PROCESSES": "4", "HVD_LOCAL_SIZE": "3"}, ValueError),
])
def test_bad_identity_env_raises(monkeypatch, env, err):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_PROCESS_ID", "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    core.shutdown()
    with pytest.raises(err):
        core.init(device="cpu")
    assert not core.is_initialized()


def _port_layouts(tmp_path, nproc, local_size=None):
    rcs, outs = launch("core", nproc, tmp_path, local_size=local_size)
    assert rcs == [0] * nproc, "\n".join(outs)
    return [{k: int(v) for k, v in np.load(
        tmp_path / f"core.{r}.npz").items()} for r in range(nproc)]


def test_two_process_gloo_world_from_identity_env(tmp_path):
    got = _port_layouts(tmp_path, 2)
    assert got == [{"rank": r, "size": 2, "local_rank": r, "local_size": 2,
                    "cross_rank": 0, "cross_size": 1} for r in range(2)]


def test_local_cross_layout_matches_reference_mesh(tmp_path):
    """4 ranks, 2 per host: the port's per-process layout equals the
    reference's per-device rank math on its (cross, local) mesh."""
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:4], local_size=2)
    try:
        @hvd.spmd(in_specs=P(hvd.AXIS), out_specs=P(hvd.AXIS))
        def ranks(x):
            return jax.numpy.stack([x[0] + hvd.rank(),
                                    x[0] + hvd.local_rank(),
                                    x[0] + hvd.cross_rank()])[None]

        ref = np.asarray(ranks(jax.numpy.zeros((4,), jax.numpy.int32)))
        sizes = (hvd.size(), hvd.local_size(), hvd.cross_size())
    finally:
        hvd.shutdown()
    got = _port_layouts(tmp_path, 4, local_size=2)
    for r, lay in enumerate(got):
        assert (lay["rank"], lay["local_rank"], lay["cross_rank"]) == \
            tuple(int(v) for v in ref[r]), json.dumps(got)
        assert (lay["size"], lay["local_size"], lay["cross_size"]) == sizes


def test_reinit_keeps_the_world_and_retires_what_was_built(port_cpu_world):
    """reinit() replays the last init: rank, size and device survive and
    an allreduce works after it; a train step and a process set built
    before it raise on their next use, and new ones work."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as htt
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import MLP

    def build():
        model = MLP(4, (3,))
        opt = htt.fused_sgd(0.1, momentum=0.9)
        step = training.make_train_step(apply_fn=model,
                                        loss_fn=F.cross_entropy,
                                        optimizer=opt, loss_fetch_steps=0)
        return step, training.init_train_state(model, opt)

    x, y = torch.randn(2, 4), torch.tensor([0, 2])
    step, state = build()
    state, _ = step(state, x, y)
    ps = htt.ProcessSet([0])
    layout = {k: getattr(core, k)() for k in LAYOUT}
    device, backend, epoch = core.device(), core.backend(), core.epoch()

    core.reinit()
    assert {k: getattr(core, k)() for k in LAYOUT} == layout
    assert (core.device(), core.backend()) == (device, backend)
    assert core.epoch() == epoch + 1
    assert torch.equal(htt.allreduce(torch.ones(3), op=htt.Sum),
                       torch.ones(3))
    for stale in (lambda: step(state, x, y), lambda: step.eager(state, x, y),
                  lambda: htt.allreduce(torch.ones(3), process_set=ps)):
        with pytest.raises(RuntimeError, match="reinit"):
            stale()
    step, state = build()
    state, loss = step(state, x, y)
    assert state.step == 1 and torch.isfinite(loss)
    assert torch.equal(htt.allreduce(torch.ones(3), process_set=htt.
                                     ProcessSet([0])), torch.ones(3))
