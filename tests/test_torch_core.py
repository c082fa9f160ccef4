"""horovod_tpu_torch.core against horovod_tpu.core: the rank / size /
local / cross layout for a world of 1, for a 2-process gloo world from
the launcher's identity env, and for a 4-process world with 2 per host
against the reference's SPMD rank math on a 4-device (cross 2, local 2)
mesh."""

import datetime
import json
import time

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


def test_failed_rank_ends_the_job_with_every_rank_output(tmp_path):
    """A rank that fails ends the job at once: launch kills the rank
    still waiting in init and reports both ranks' output."""
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as err:
        launch("fail", 2, tmp_path)
    assert time.monotonic() - t0 < 30
    msg = str(err.value)
    assert "planted failure of rank 1" in msg
    assert "--- rank 0 ---" in msg and "--- rank 1 ---" in msg


def test_rendezvous_is_bounded(monkeypatch):
    """Rank 0 of a world of 2 whose rank 1 never comes raises after
    HVD_START_TIMEOUT seconds instead of waiting for it."""
    import torch.distributed as dist

    server = dist.TCPStore("localhost", 0, 2, is_master=True,
                           wait_for_workers=False, multi_tenant=True,
                           timeout=datetime.timedelta(seconds=5))
    for k, v in {"HVD_COORDINATOR_ADDR": f"localhost:{server.port}",
                 "HVD_NUM_PROCESSES": "2", "HVD_PROCESS_ID": "0",
                 "HVD_START_TIMEOUT": "1"}.items():
        monkeypatch.setenv(k, v)
    core.shutdown()
    t0 = time.monotonic()
    with pytest.raises(dist.DistError):
        core.init(device="cpu")
    assert time.monotonic() - t0 < 15
    assert not core.is_initialized()


def test_reinit_keeps_the_world_and_retires_what_was_built(port_cpu_world):
    """reinit() replays the last init: rank, size and device survive and
    an allreduce works after it; a train step built before it builds
    itself again at its next call (eagerly or not) and trains on, a
    process set built before it raises on its next use, and new ones
    work."""
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
    state, loss = step(state, x, y)
    assert state.step == 2 and torch.isfinite(loss)
    assert len(step.builds) == 2
    state, loss = step.eager(state, x, y)
    assert state.step == 3 and torch.isfinite(loss)
    with pytest.raises(RuntimeError, match="reinit"):
        htt.allreduce(torch.ones(3), process_set=ps)
    step, state = build()
    state, loss = step(state, x, y)
    assert state.step == 1 and torch.isfinite(loss)
    assert torch.equal(htt.allreduce(torch.ones(3), process_set=htt.
                                     ProcessSet([0])), torch.ones(3))


def test_spmd_surface_thin_forms_match_the_reference_names(port_cpu_world,
                                                           hvd_init):
    """Where the reference's SPMD surface has a meaning in a
    process-per-card world: the axis names, the world's 1-D mesh and the
    (cross, local) mesh as DeviceMeshes (made once a world), and
    ``in_spmd`` — False outside the reference's SPMD region too."""
    import horovod_tpu_torch as htt

    assert (htt.AXIS, htt.CROSS_AXIS, htt.LOCAL_AXIS) == \
        (hvd.AXIS, hvd.CROSS_AXIS, hvd.LOCAL_AXIS)
    assert htt.in_spmd() is hvd.in_spmd() is False
    m = htt.mesh()
    assert m.mesh_dim_names == hvd.mesh().axis_names == (htt.AXIS,)
    assert tuple(m.shape) == (htt.size(),) and htt.mesh() is m
    h = htt.hierarchical_mesh()
    assert h.mesh_dim_names == hvd.hierarchical_mesh().axis_names
    assert tuple(h.shape) == (htt.cross_size(), htt.local_size())
    htt.reinit()
    assert htt.mesh() is not m
    for name in ("spmd", "rank_context", "sharded", "replicated",
                 "put_per_rank", "get_per_rank"):
        assert hasattr(hvd, name) and not hasattr(htt, name)
