"""horovod_tpu_torch.examples.multichip_drives against the reference's
model-parallel drives in ``__graft_entry__.py`` (``dryrun_multichip``).

Each drive takes one training step with the reference's shapes, seeds
and learning rate and returns its loss.  The port runs them in gloo jobs
of ``tests/torch_dist_worker.py`` (task ``drives``): dp×sp, dp×tp
(from the reference's initial flax weights), dp×pp and ep at 4 ranks,
dp×tp×pp at 8; the reference runs ``_dryrun_*`` on as many CPU devices.
Tolerance 1e-5 (float32, sums in other orders).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.parallel.tensor_parallel import ParallelMLP as RefMLP
from horovod_tpu_torch.convert import flatten_flax
from torch_dist_worker import launch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as graft  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
#: drive -> (the reference's function, world size)
DRIVES = {"dp_sp": (graft._dryrun_dp_sp, 4), "dp_tp": (graft._dryrun_dp_tp, 4),
          "dp_pp": (graft._dryrun_dp_pp, 4), "ep": (graft._dryrun_ep, 4),
          "dp_tp_pp": (graft._dryrun_dp_tp_pp, 8)}


def _dp_tp_initial_params():
    """The reference dp×tp drive's initial weights (its own init call)."""
    with jax.default_device(jax.devices("cpu")[0]):
        params = RefMLP(hidden=64, out=8, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 16)))["params"]
    return flatten_flax(params)


@pytest.fixture(scope="module")
def port_losses(tmp_path_factory):
    losses = {}
    for world in (4, 8):
        workdir = tmp_path_factory.mktemp(f"drives{world}")
        np.savez(workdir / "inputs.npz", **_dp_tp_initial_params())
        launch("drives", world, workdir, timeout=120)
        per_rank = [dict(np.load(workdir / f"drives.{r}.npz"))
                    for r in range(world)]
        for name in per_rank[0]:
            values = {float(res[name]) for res in per_rank}
            assert len(values) == 1, (name, values)   # every rank agrees
            losses[name] = values.pop()
    return losses


@pytest.mark.parametrize("drive", list(DRIVES))
def test_drive_loss_matches_reference(port_losses, drive):
    fn, world = DRIVES[drive]
    with jax.default_device(jax.devices("cpu")[0]):
        want = fn(jax.devices("cpu"), world)
    np.testing.assert_allclose(port_losses[drive], want, **TOL)
