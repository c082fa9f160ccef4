"""horovod_tpu_torch.runtime.controller against horovod_tpu.runtime.controller:
the two packages' clients and servers mixed in one process over loopback.

The server and the client are the C++ of ``csrc/controller.cc`` in both
packages (each package builds its own copy of the library), so a port
client must negotiate with a reference server and the other way round as
either does with its own.  One scenario runs on every pairing of server
and clients (reference / port): three tensors submitted by two ranks,
twice, then three fused by a join (the groups, and the order the
coordinator broadcasts), the host data plane (sum, min, max and Adasum
reductions,
an allgather of payloads of different sizes, a broadcast from rank 1)
and the counters a client reads over the wire.  Every pairing gives the
same groups, order stream, data-plane bytes and counters.

The coordinator reads one message from each client a cycle, so two ranks
submitting the same names in the same order negotiate them one by one,
in that order; a name already negotiated once is a response-cache hit
the second time.  Fusion needs several tensors ready in one cycle: rank
0 submits three and, once the coordinator has read them (its cycle
count), rank 1 joins (a joined rank counts for every tensor): the three
come back as one fused group.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from horovod_tpu.runtime import controller as ref_ctl
from horovod_tpu.runtime import native as ref_native
from horovod_tpu_torch.runtime import controller as port_ctl
from horovod_tpu_torch.runtime import native as port_native

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()),
    reason="native core failed to build")

PACKAGES = {"ref": ref_ctl, "port": port_ctl}
NAMES = (("grad.b", (4,)), ("grad.a", (8, 2)), ("grad.c", (3,)))


def _both(fn0, fn1):
    """Run the two ranks' halves of a collective at once."""
    with ThreadPoolExecutor(2) as pool:
        f0, f1 = pool.submit(fn0), pool.submit(fn1)
        return f0.result(timeout=30), f1.result(timeout=30)


def _scenario(server_pkg: str, client_pkg: str) -> dict:
    srv = PACKAGES[server_pkg].ControllerServer(
        2, cycle_ms=5.0, fusion_threshold=1 << 20, stall_warn_sec=60.0)
    cls = PACKAGES[client_pkg].ControllerClient
    c0 = cls("127.0.0.1", srv.port, 0)
    c1 = cls("127.0.0.1", srv.port, 1)
    try:
        c0.enable_order_stream()
        burst = threading.Barrier(2)

        def submit(c):
            burst.wait()
            for name, shape in NAMES:
                c.submit(name, shape=shape, dtype="float32")

        groups = []
        for _ in range(2):  # the second round: response-cache hits
            _both(lambda: submit(c0), lambda: submit(c1))
            groups += [[c.wait(name, timeout=10) for name, _ in NAMES]
                       for c in (c0, c1)]
        start = srv.cycles
        for name, shape in NAMES:
            c0.submit("f" + name, shape=shape, dtype="float32")
        # the requests are sent; a cycle reads one of them, so after
        # len(NAMES) + 1 more cycles every one was read before the join
        deadline = time.monotonic() + 30
        while srv.cycles < start + len(NAMES) + 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        c1.join()
        fused = [c0.wait("f" + name, timeout=10) for name, _ in NAMES]
        c0.join()
        c0.wait_join(timeout=10)
        c1.wait_join(timeout=10)
        stream = [c0.next_negotiated(timeout=10) for _ in range(7)]

        rng = np.random.default_rng(5)
        a = rng.standard_normal((2, 1000)).astype(np.float32)
        data = {}
        for op in ("allreduce", "min", "max", "adasum"):
            r0, r1 = _both(
                lambda: c0.allreduce_data(f"d.{op}", a[0], op=op),
                lambda: c1.allreduce_data(f"d.{op}", a[1], op=op))
            assert r0.tobytes() == r1.tobytes()
            data[op] = r0.tobytes()
        g0, g1 = _both(lambda: c0.allgather_data("d.gather", b"r0"),
                       lambda: c1.allgather_data("d.gather", b"rank1!"))
        assert g0 == g1
        data["allgather"] = g0
        b0, b1 = _both(
            lambda: c0.broadcast_data("d.bcast", b"", root_rank=1),
            lambda: c1.broadcast_data("d.bcast", b"from one", root_rank=1))
        assert b0 == b1
        data["broadcast"] = b0
        stats = c0.stats()
        assert stats == c1.stats() or stats["cycles"] != c1.stats()["cycles"]
        assert stats["cycles"] > 0
        stats.pop("cycles")  # the coordinator's clock, not the protocol
        return {"groups": groups, "fused": fused, "stream": stream,
                "data": data,
                "stats": stats, "expected_sum": (a[0] + a[1]).tobytes()}
    finally:
        c0.close()
        c1.close()
        srv.stop()


def test_dtype_codes_match_reference():
    for dt in ("float32", "bfloat16", "float16", "float64", "int32",
               "int64", "uint8", "bool", np.float32, np.dtype("int64"),
               "complex64"):
        assert port_ctl._dtype_code(dt) == ref_ctl._dtype_code(dt), dt
    assert port_ctl.REQUEST_TYPES == ref_ctl.REQUEST_TYPES
    assert port_ctl.DATA_OPS == ref_ctl.DATA_OPS


@pytest.mark.parametrize("server_pkg,client_pkg", [("ref", "port"),
                                                   ("port", "ref"),
                                                   ("port", "port")])
def test_mixed_server_and_clients_negotiate_as_the_reference(server_pkg,
                                                              client_pkg):
    want = _scenario("ref", "ref")
    got = _scenario(server_pkg, client_pkg)
    assert got == want
    names = [n for n, _ in NAMES]
    assert want["groups"] == [[[n] for n in names]] * 4
    fused = sorted("f" + n for n in names)  # the coordinator's name order
    assert want["fused"] == [fused] * 3
    assert [[t[0] for t in r[2]] for r in want["stream"]] == \
        [[n] for n in names] * 2 + [fused]
    assert want["stats"] == {"cache_hits": 3, "stall_warnings": 0}
    assert want["data"]["allreduce"] == want["expected_sum"]
    assert want["data"]["allgather"] == [b"r0", b"rank1!"]
    assert want["data"]["broadcast"] == b"from one"
