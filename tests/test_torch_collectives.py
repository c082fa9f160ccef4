"""horovod_tpu_torch.ops.collectives against horovod_tpu.ops.collectives.

One 4-rank gloo job (``tests/torch_dist_worker.py``, task
``collectives``) runs every collective of the port, over the whole
world and over the process set {0, 2}, with pre- and post-scaling and
an allgatherv of 3, 0, 2 and 1 valid rows; it is launched once for the
module.  Each case holds every rank's result against the reference's
same collective on a 4-device CPU mesh, from the same per-rank inputs:
float32 sums in another order, so to 1e-6 (rtol and atol); moves and
gathers exactly.  A rank outside the process set gets its input back
(the port's rule; the reference leaves that value undefined).  At one
rank, the reductions the wire tier adds (Adasum, hierarchical,
two-level, compression) against the input and the reference.
"""

import jax
import numpy as np
import pytest

import horovod_tpu as hvd
from torch_dist_worker import (
    ALLGATHERV_ROWS, COLLECTIVE_SET, collective_inputs, launch,
)

WORLD = 4
TOL = 1e-6


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("collectives")
    rcs, outs = launch("collectives", WORLD, workdir)
    assert rcs == [0] * WORLD, "\n".join(outs)
    return [dict(np.load(workdir / f"collectives.{r}.npz"))
            for r in range(WORLD)]


def _reference_cases(ps):
    """``{case: per-rank fn(x, g0, g1, g2, v, rows) -> list}`` in the
    reference's SPMD form, matching the worker's cases."""
    def rs(**kw):
        return lambda x, g0, g1, g2, v, rows: [hvd.allreduce(x, **kw)]

    return {
        "allreduce_sum": rs(op=hvd.Sum),
        "allreduce_average": rs(),
        "allreduce_min": rs(op=hvd.Min),
        "allreduce_max": rs(op=hvd.Max),
        "allreduce_scaled": rs(prescale_factor=0.5, postscale_factor=3.0),
        "allreduce_set_sum": rs(op=hvd.Sum, process_set=ps),
        "allreduce_set_scaled": rs(process_set=ps, prescale_factor=0.5,
                                   postscale_factor=3.0),
        "grouped_allreduce": lambda x, g0, g1, g2, v, rows: list(
            hvd.grouped_allreduce([g0, g1, g2], op=hvd.Sum,
                                  threshold_bytes=32)),
        "grouped_allreduce_set": lambda x, g0, g1, g2, v, rows: list(
            hvd.grouped_allreduce([g0, g1, g2], process_set=ps)),
        "allreduce_gradients": lambda x, g0, g1, g2, v, rows: (
            lambda r: [r["a"], r["b"]["c"]])(hvd.allreduce_gradients(
                {"a": g0, "b": {"c": g1}})),
        "allgather": lambda x, g0, g1, g2, v, rows: [hvd.allgather(x)],
        "allgather_set": lambda x, g0, g1, g2, v, rows: [
            hvd.allgather(x, process_set=ps)],
        "allgatherv": lambda x, g0, g1, g2, v, rows: list(
            hvd.allgatherv(v, valid_rows=rows, max_rows=3)),
        "allgatherv_set": lambda x, g0, g1, g2, v, rows: list(
            hvd.allgatherv(v, valid_rows=rows, max_rows=3,
                           process_set=ps)),
        "broadcast": lambda x, g0, g1, g2, v, rows: [
            hvd.broadcast(x, root_rank=1)],
        "broadcast_set": lambda x, g0, g1, g2, v, rows: [
            hvd.broadcast(x, root_rank=2, process_set=ps)],
        "alltoall": lambda x, g0, g1, g2, v, rows: [hvd.alltoall(x)],
        "alltoall_set": lambda x, g0, g1, g2, v, rows: [
            hvd.alltoall(x, process_set=ps)],
        "reducescatter": lambda x, g0, g1, g2, v, rows: [
            hvd.reducescatter(x)],
        "reducescatter_average": lambda x, g0, g1, g2, v, rows: [
            hvd.reducescatter(x, op=hvd.Average)],
        "reducescatter_set": lambda x, g0, g1, g2, v, rows: [
            hvd.reducescatter(x, process_set=ps)],
    }


CASES = list(_reference_cases(None))


@pytest.fixture(scope="module")
def reference_results():
    """Every case on the reference's 4-device CPU mesh: ``{case: [per
    rank: [outputs]]}``."""
    inputs = [collective_inputs(r) for r in range(WORLD)]
    names = ("x", "g0", "g1", "g2", "v")
    stacked = [np.stack([inp[k] for inp in inputs]) for k in names]
    rows = np.asarray(ALLGATHERV_ROWS, np.int32)
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:WORLD])
    try:
        ps = hvd.ProcessSet(COLLECTIVE_SET)
        out = {}
        for case, fn in _reference_cases(ps).items():
            @hvd.spmd
            def per_rank(x, g0, g1, g2, v, c, fn=fn):
                return [o[None] for o in fn(x[0], g0[0], g1[0], g2[0], v[0],
                                            c[0])]

            got = per_rank(*stacked, rows)
            per = [hvd.get_per_rank(o) for o in got]
            out[case] = [[np.asarray(p[r]) for p in per]
                         for r in range(WORLD)]
        return out
    finally:
        hvd.shutdown()


def test_case_lists_agree():
    from torch_dist_worker import collective_cases

    assert list(collective_cases(None, None, {k: None for k in (
        "x", "g0", "g1", "g2", "v")}, 0)) == CASES


@pytest.mark.parametrize("case", CASES)
def test_collective_matches_reference(port_results, reference_results,
                                      case):
    members = COLLECTIVE_SET if "_set" in case else range(WORLD)
    for r in range(WORLD):
        got = port_results[r]
        outs = [got[f"{case}/{i}"] for i in range(len(
            [k for k in got if k.startswith(case + "/")]))]
        if r not in members:
            # outside the set: the input back (allgatherv's own padded
            # rows and count)
            mine = {k[len("input/"):]: v for k, v in got.items()
                    if k.startswith("input/")}
            n = ALLGATHERV_ROWS[r]
            want = {"allgatherv_set": [np.where(
                np.arange(3)[:, None] < n, mine["v"], 0), [n]],
                "grouped_allreduce_set": [mine[k] for k in (
                    "g0", "g1", "g2")]}.get(case, [mine["x"]])
            assert len(outs) == len(want), case
            for o, w in zip(outs, want):
                np.testing.assert_array_equal(o, w)
            continue
        want = reference_results[case][r]
        assert len(outs) == len(want), case
        for o, w in zip(outs, want):
            assert o.shape == w.shape, (case, r)
            np.testing.assert_allclose(o, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{case} rank {r}")


def test_allgatherv_row_counts_and_padding(port_results):
    """The numpy oracle of the reference's own allgatherv test: each
    rank's valid rows in rank order, the padding zero, the counts."""
    inputs = [collective_inputs(r) for r in range(WORLD)]
    for r in range(WORLD):
        gathered = port_results[r]["allgatherv/0"].reshape(WORLD, 3, 2)
        np.testing.assert_array_equal(port_results[r]["allgatherv/1"],
                                      ALLGATHERV_ROWS)
        for src, n in enumerate(ALLGATHERV_ROWS):
            np.testing.assert_array_equal(gathered[src, :n],
                                          inputs[src]["v"][:n])
            np.testing.assert_array_equal(gathered[src, n:], 0)


@pytest.fixture()
def port_cpu_world(monkeypatch):
    from horovod_tpu_torch import core

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


@pytest.mark.parametrize("kw", [
    {"op": "Adasum"}, {"hierarchical": True}, {"two_level": True},
    {"op": "Adasum", "hierarchical": True},
    {"op": "Sum", "two_level": True, "prescale_factor": 2.0},
])
def test_one_rank_adasum_hierarchical_and_two_level(port_cpu_world, kw):
    """The reductions the wire tier adds, at one rank: the input back
    (scaled); across 4 ranks, tests/test_torch_wire.py."""
    import torch

    from horovod_tpu_torch.ops import collectives

    x = torch.randn(5)
    out = collectives.allreduce(x, **kw)
    np.testing.assert_array_equal(out.numpy(),
                                  (x * kw.get("prescale_factor", 1)).numpy())


@pytest.mark.parametrize("name", ["int8", "ef_int8", "bf16"])
def test_one_rank_compressed_allreduce_matches_reference(port_cpu_world,
                                                         name):
    """``allreduce`` compresses with ``compress_for`` over its group: at
    one rank the full range, as the reference's on a 1-device mesh."""
    import torch

    from horovod_tpu.ops.compression import Compression as RefCompression
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.ops.compression import Compression

    x = np.random.default_rng(6).normal(size=(9,)).astype(np.float32)
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        @hvd.spmd
        def run(a):
            return hvd.allreduce(a[0], compression=RefCompression.lookup(
                name))[None]

        want = np.asarray(hvd.get_per_rank(run(x[None]))[0])
    finally:
        hvd.shutdown()
    got = collectives.allreduce(torch.from_numpy(x),
                                compression=Compression.lookup(name))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_adasum_is_no_bucketed_op_and_hierarchical_min_max_raise(
        port_cpu_world):
    import torch

    from horovod_tpu_torch.ops import collectives

    with pytest.raises(ValueError, match="allreduce\\(op=Adasum\\)"):
        collectives.reduce_op("Adasum")
    with pytest.raises(ValueError, match="Sum/Average/Adasum"):
        collectives.allreduce(torch.ones(2), op="Max", hierarchical=True)
    with pytest.raises(ValueError, match="process subset"):
        collectives.allreduce(torch.ones(2), two_level=True,
                              process_set=collectives.ProcessSet([0]))
