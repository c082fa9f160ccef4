"""horovod_tpu_torch.elastic.join against horovod_tpu.elastic.join.

At one rank on the CPU: ``join_allreduce`` (Average of an active rank,
Sum, and no division by zero when every rank has joined) and
``join_count`` against the reference's on a 1-device mesh, exactly;
``join`` returns the rank.  Across ranks (rank 3 joined),
``tests/test_torch_wire.py``.
"""

import jax
import numpy as np
import pytest
import torch

import horovod_tpu as hvd
from horovod_tpu.elastic import join as ref
from horovod_tpu_torch import core
from horovod_tpu_torch.elastic import join as port


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def _ref(fn, *args):
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        @hvd.spmd
        def run(*xs):
            return fn(*(x[0] for x in xs))[None]

        return np.asarray(hvd.get_per_rank(run(*(np.asarray(a)[None]
                                                 for a in args)))[0])
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("active", [True, False])
@pytest.mark.parametrize("op", ["Average", "Sum"])
def test_join_allreduce_matches_reference(port_cpu_world, active, op):
    x = np.random.default_rng(1).normal(size=(6,)).astype(np.float32)
    want = _ref(lambda t, a: ref.join_allreduce(t, a, op=op), x,
                np.asarray(active))
    got = port.join_allreduce(torch.from_numpy(x), active, op=op)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("active", [True, False])
def test_join_count_matches_reference(port_cpu_world, active):
    want = _ref(lambda a: ref.join_count(a), np.asarray(active))
    assert int(port.join_count(active)) == int(want)


def test_join_and_bad_op(port_cpu_world):
    assert port.join() == 0
    with pytest.raises(ValueError, match="Average/Sum"):
        port.join_allreduce(torch.ones(2), True, op="Max")
