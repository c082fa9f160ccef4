"""horovod_tpu_torch.ops.sparse against horovod_tpu.ops.sparse.

``to_dense`` (duplicate ids add), ``embedding_grad_as_slices`` (the
loss and the rows' gradient) and ``densify_tree`` against the
reference's on the same seeded tables and ids, to float32 rounding
(1e-6); at one rank on the CPU, ``allreduce_indexed_slices`` and the
sparse branch of ``allreduce_pytree`` (Average, Sum, densified, and a
sparse leaf's residual left untouched).  Across ranks,
``tests/test_torch_wire.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import sparse as ref
from horovod_tpu_torch import core
from horovod_tpu_torch.ops import compression as port_comp
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops import sparse as port


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def _slices(seed, k=5, vocab=7, dim=3):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(k, dim)).astype(np.float32)
    ids = rng.integers(0, vocab, size=(k,)).astype(np.int32)
    ids[1] = ids[0]                           # a duplicate id
    return vals, ids, (vocab, dim)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_to_dense_matches_reference(seed):
    vals, ids, shape = _slices(seed)
    want = np.asarray(ref.to_dense(ref.IndexedSlices(
        jnp.asarray(vals), jnp.asarray(ids), shape)))
    got = port.to_dense(port.IndexedSlices(
        torch.from_numpy(vals), torch.from_numpy(ids), shape))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_embedding_grad_as_slices_matches_reference():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(9, 4)).astype(np.float32)
    ids = np.array([[1, 3, 3], [0, 8, 1]], np.int32)
    target = rng.normal(size=(2, 3, 4)).astype(np.float32)

    r_loss, r_sl = ref.embedding_grad_as_slices(
        lambda rows, t: jnp.sum((rows - t) ** 2), jnp.asarray(table),
        jnp.asarray(ids), jnp.asarray(target))
    table_t = torch.from_numpy(table)
    p_loss, p_sl = port.embedding_grad_as_slices(
        lambda rows, t: torch.sum((rows - t) ** 2), table_t,
        torch.from_numpy(ids).long(), torch.from_numpy(target))
    assert float(p_loss) == pytest.approx(float(r_loss), rel=1e-6)
    assert p_sl.dense_shape == tuple(r_sl.dense_shape)
    np.testing.assert_allclose(p_sl.values.numpy(), np.asarray(r_sl.values),
                               rtol=1e-6)
    np.testing.assert_array_equal(p_sl.indices.numpy(),
                                  np.asarray(r_sl.indices))
    assert table_t.grad is None


def test_densify_tree_matches_reference():
    vals, ids, shape = _slices(3)
    dense = np.arange(6, dtype=np.float32)
    want = ref.densify_tree({"e": ref.IndexedSlices(
        jnp.asarray(vals), jnp.asarray(ids), shape), "d": jnp.asarray(dense)})
    got = port.densify_tree({"e": port.IndexedSlices(
        torch.from_numpy(vals), torch.from_numpy(ids), shape),
        "d": torch.from_numpy(dense)})
    for k in ("e", "d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    assert port.is_indexed_slices(port.IndexedSlices(
        torch.ones(1, 2), torch.zeros(1), (3, 2)))
    assert not port.is_indexed_slices(torch.ones(2))


@pytest.mark.parametrize("op", ["Average", "Sum"])
def test_one_rank_sparse_allreduce(port_cpu_world, op):
    vals, ids, shape = _slices(4)
    s = port.IndexedSlices(torch.from_numpy(vals), torch.from_numpy(ids),
                           shape)
    out = port.allreduce_indexed_slices(s, op=op)
    np.testing.assert_array_equal(out.values.numpy(), vals)
    np.testing.assert_array_equal(out.indices.numpy(), ids)
    with pytest.raises(ValueError, match="unsupported op"):
        port.allreduce_indexed_slices(s, op="Max")


@pytest.mark.parametrize("as_dense", [False, True])
def test_pytree_sparse_branch_and_residual(port_cpu_world, as_dense):
    vals, ids, shape = _slices(6)
    s = port.IndexedSlices(torch.from_numpy(vals), torch.from_numpy(ids),
                           shape)
    w = torch.linspace(-1, 1, 5)
    res = {"e": torch.full(shape, 3.0), "w": torch.zeros(5)}
    out, new = fusion.allreduce_pytree(
        {"e": s, "w": w}, compression=port_comp.ErrorFeedback(
            port_comp.Int8Compressor), residual=res,
        sparse_as_dense=as_dense)
    if as_dense:
        dense = port.to_dense(s) + 3.0       # the residual joins the sum
        np.testing.assert_allclose(out["e"].numpy(), dense.numpy(),
                                   atol=dense.abs().max().item() / 127)
        assert new["e"] is not res["e"]
    else:
        assert port.is_indexed_slices(out["e"]) and new["e"] is res["e"]
        np.testing.assert_array_equal(out["e"].values.numpy(), vals)
    np.testing.assert_allclose(out["w"].numpy(), w.numpy(), atol=1 / 127)
    np.testing.assert_allclose((out["w"] + new["w"]).numpy(), w.numpy(),
                               atol=1e-6)
