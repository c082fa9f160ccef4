"""horovod_tpu_torch.runtime.ring against horovod_tpu.runtime.ring: the
native peer ring over loopback, every rank of it in this process.

* ``Ring`` for 2 and 3 ranks (one thread a rank): Sum, Min and Max
  reduced on the ring, Average as the process plane makes it (the ring's
  sum over the world size), an odd length so the segments split
  unevenly, float32 and float64; the result on every rank bit-equal to
  the reference's ``Ring`` on the same inputs.  Adasum runs on the
  coordinator star (``allreduce_data(op="adasum")``, its VHDD tree), so
  its case sums there, port clients against reference clients.
* the ring's broadcast and allgather, and ``RingExecutor`` (ops ordered
  by the coordinator, same-op ring reductions of one negotiated group
  fused into one transfer) over the port's controller, against numpy.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from horovod_tpu.runtime import controller as ref_ctl
from horovod_tpu.runtime import native as ref_native
from horovod_tpu.runtime import ring as ref_ring
from horovod_tpu_torch.runtime import controller as port_ctl
from horovod_tpu_torch.runtime import native as port_native
from horovod_tpu_torch.runtime import ring as port_ring

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()),
    reason="native core failed to build")

LENGTH = 10_007


def _rings(mod, n: int, chunk: int = 4096):
    rings = [mod.Ring(r, n, chunk_bytes=chunk) for r in range(n)]
    with ThreadPoolExecutor(n) as pool:
        list(pool.map(lambda r: rings[r].connect(
            "127.0.0.1", rings[(r + 1) % n].port, timeout=10), range(n)))
    return rings


def _on_every_rank(rings, fn):
    with ThreadPoolExecutor(len(rings)) as pool:
        return list(pool.map(lambda r: fn(r, rings[r]), range(len(rings))))


def _inputs(n: int, dtype):
    rng = np.random.default_rng(11 + n)
    return [rng.standard_normal(LENGTH).astype(dtype) for _ in range(n)]


def _reduce(mod, n, arrays, op):
    rings = _rings(mod, n)
    try:
        wire = "allreduce" if op == "average" else op
        outs = _on_every_rank(rings, lambda r, ring: ring.allreduce(
            arrays[r].copy(), op=wire))
    finally:
        for ring in rings:
            ring.close()
    if op == "average":
        outs = [o / n for o in outs]
    return outs


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("op", ["allreduce", "average", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ring_reduction_is_bit_equal_to_reference(n, op, dtype):
    arrays = _inputs(n, dtype)
    want = _reduce(ref_ring, n, arrays, op)
    got = _reduce(port_ring, n, arrays, op)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert all(g.tobytes() == got[0].tobytes() for g in got)
    if op == "allreduce" and n == 2:
        assert got[0].tobytes() == (arrays[0] + arrays[1]).tobytes()


@pytest.mark.parametrize("n", [2, 3])
def test_adasum_on_the_star_is_bit_equal_to_reference(n):
    arrays = _inputs(n, np.float32)

    def adasum(mod):
        srv = mod.ControllerServer(n, cycle_ms=2.0)
        clients = [mod.ControllerClient("127.0.0.1", srv.port, r)
                   for r in range(n)]
        try:
            with ThreadPoolExecutor(n) as pool:
                return list(pool.map(lambda r: clients[r].allreduce_data(
                    "adasum.t", arrays[r], op="adasum"), range(n)))
        finally:
            for c in clients:
                c.close()
            srv.stop()

    want, got = adasum(ref_ctl), adasum(port_ctl)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("n", [2, 3])
def test_broadcast_and_allgather_match_reference(n):
    arrays = _inputs(n, np.float32)
    out = {}
    for name, mod in (("ref", ref_ring), ("port", port_ring)):
        rings = _rings(mod, n)
        try:
            out[name] = (
                _on_every_rank(rings, lambda r, ring: bytes(ring.broadcast(
                    bytearray(arrays[r].tobytes()), root=n - 1))),
                _on_every_rank(rings, lambda r, ring: ring.allgather(
                    arrays[r].reshape(-1, 1)).tobytes()))
        finally:
            for ring in rings:
                ring.close()
    assert out["port"] == out["ref"]
    assert out["port"][0] == [arrays[-1].tobytes()] * n
    assert out["port"][1] == [np.concatenate(arrays).tobytes()] * n


def test_executor_orders_and_fuses_by_the_coordinator():
    """Three ranks, each submitting two ring reductions and a broadcast
    from threads in a different order: the coordinator's order runs them
    the same way on every rank; the results are numpy's."""
    n = 3
    arrays = _inputs(n, np.float32)
    srv = port_ctl.ControllerServer(n, cycle_ms=2.0)
    clients = [port_ctl.ControllerClient("127.0.0.1", srv.port, r)
               for r in range(n)]
    executors = [None] * n
    try:
        with ThreadPoolExecutor(n) as pool:
            executors = list(pool.map(lambda r: port_ring.establish(
                clients[r], r, n, host="127.0.0.1"), range(n)))
        assert all(e is not None for e in executors)
        barrier = threading.Barrier(n)

        def rank_ops(r):
            ex = executors[r]
            barrier.wait()
            order = [0, 1, 2] if r % 2 else [2, 1, 0]
            results = {}

            def run(i):
                if i == 0:
                    return ex.allreduce("sum", arrays[r])
                if i == 1:
                    return ex.allreduce("max", arrays[r], op="max")
                return ex.broadcast("bcast", arrays[r], root=1)

            with ThreadPoolExecutor(3) as inner:
                futs = {i: inner.submit(run, i) for i in order}
                for i, f in futs.items():
                    results[i] = f.result(timeout=30)
            return results

        with ThreadPoolExecutor(n) as pool:
            outs = list(pool.map(rank_ops, range(n)))
        total = arrays[0] + arrays[1] + arrays[2]
        for out in outs:
            np.testing.assert_allclose(out[0], total, rtol=1e-6, atol=1e-6)
            assert out[0].tobytes() == outs[0][0].tobytes()
            assert np.array_equal(out[1], np.maximum.reduce(arrays))
            assert np.array_equal(out[2], arrays[1])
    finally:
        for e in executors:
            if e is not None:
                e.close()
        for c in clients:
            c.close()
        srv.stop()
