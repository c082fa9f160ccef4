"""Test harness: 8 virtual CPU devices stand in for an 8-chip slice.

The reference simulates "multi-node" as N processes on localhost under
``mpirun -np 2 -H localhost:2`` (reference docker-compose.test.yml:52,
.buildkite/gen-pipeline.sh:110-113).  The TPU-native analog (SURVEY §4) is
a single process with ``--xla_force_host_platform_device_count=8``: eight
XLA CPU devices form the mesh, and SPMD programs over it exercise the same
collective logic that runs over ICI on a real slice.
"""

import os

# Must be set before jax initializes its backends.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import horovod_tpu as hvd  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long compile-heavy drives excluded from the tier-1 budget "
        "(run explicitly or without -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (horovod_tpu_torch kernels); skips "
        "without one",
    )


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices("cpu")
    assert len(devs) >= 8, (
        "tests need --xla_force_host_platform_device_count=8"
    )
    return devs[:8]


@pytest.fixture()
def hvd_init(cpu_devices):
    """Fresh 8-rank world per test (2 simulated nodes x 4 local ranks)."""
    hvd.shutdown()
    hvd.init(devices=cpu_devices, local_size=4)
    yield hvd
    hvd.shutdown()


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
