"""horovod_tpu_torch.ops.adasum against horovod_tpu.ops.adasum.

The coefficient merge against the reference's ``_adasum_combine`` and
``numpy_adasum_pair`` on seeded vectors (float32 dots against float64:
1e-5), including zero-norm operands, which merge as a plain sum; the
distance-doubling recursion ``_vhdd`` with the partner exchange played
by the harness for 4, 8 and 16 simulated ranks against ``numpy_adasum``,
every rank bit-identical (the canonical operand order); ``_vhdd``
itself on 8 threaded ranks, the harness playing the exchange, against
the reference's Adasum on its 8-device CPU mesh (1e-5); the identity at
world size 1 and the power-of-two checks.  Across processes
``tests/test_torch_wire.py`` holds the flat, hierarchical and
process-set forms against the reference's mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import adasum as ref
from horovod_tpu_torch import core
from horovod_tpu_torch.ops import adasum as port


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def _dots(a, b):
    return a @ b, a @ a, b @ b


@pytest.mark.parametrize("case", ["random", "parallel", "orthogonal",
                                  "zero_a", "zero_b", "both_zero"])
def test_combine_matches_reference(case):
    rng = np.random.default_rng(["random", "parallel", "orthogonal", "zero_a",
                                 "zero_b", "both_zero"].index(case))
    a = rng.normal(size=(37,)).astype(np.float32)
    b = rng.normal(size=(37,)).astype(np.float32)
    if case == "parallel":
        b = 3 * a
    elif case == "orthogonal":
        a[18:], b[:18] = 0, 0
    if case in ("zero_a", "both_zero"):
        a[:] = 0
    if case in ("zero_b", "both_zero"):
        b[:] = 0
    dot, na2, nb2 = (np.float32(v) for v in _dots(a, b))
    want = np.asarray(ref._adasum_combine(
        jnp.asarray(a), jnp.asarray(b), jnp.float32(dot), jnp.float32(na2),
        jnp.float32(nb2)))
    got = port._adasum_combine(
        torch.from_numpy(a), torch.from_numpy(b), *(torch.tensor(v) for v in
                                                    (dot, na2, nb2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.numpy(), ref.numpy_adasum_pair(a, b),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vhdd_simulated_ranks_match_numpy_adasum(n, dtype):
    """Every simulated rank merges level by level as ``_vhdd`` does (the
    next test holds ``_vhdd`` to this merge), its partner's vector of
    the same level handed over by the harness."""
    rng = np.random.default_rng(n)
    vals = [torch.from_numpy(rng.normal(size=(29,)).astype(np.float32)).to(
        dtype) for _ in range(n)]
    cur = list(vals)
    level = 1
    while level < n:
        cur = [_one_level(cur, r, level) for r in range(n)]
        level *= 2
    for c in cur[1:]:
        assert torch.equal(c, cur[0])
    want = ref.numpy_adasum([v.float().numpy() for v in vals])
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(cur[0].float().numpy(), want, rtol=tol,
                               atol=tol)


def _one_level(cur, r, level):
    """One level of ``_vhdd`` on rank ``r``: its partner's vector and the
    parity order, as the recursion computes it."""
    a, b = cur[r], cur[r ^ level]
    af, bf = a.float(), b.float()
    dots = torch.stack([torch.sum(af * bf), torch.sum(af * af),
                        torch.sum(bf * bf)])
    dot, na2, nb2 = dots
    if (r // level) % 2 == 0:
        return port._adasum_combine(af, bf, dot, na2, nb2).to(a.dtype)
    return port._adasum_combine(bf, af, dot, nb2, na2).to(a.dtype)


def test_vhdd_recursion_is_the_level_by_level_merge(monkeypatch):
    """``_vhdd`` itself, on a 2-rank pair whose exchange the harness
    answers: both members give the same merge as the level-by-level
    form."""
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.normal(size=(9,)).astype(np.float32))
            for _ in range(2))
    partner = {0: a, 1: b}      # each rank's vector, by its rank
    monkeypatch.setattr(port, "_exchange", lambda t, p: partner[p])
    lo = port._vhdd(a, 2, 0, lambda lv: 0 ^ lv)
    hi = port._vhdd(b, 2, 1, lambda lv: 1 ^ lv)
    assert torch.equal(lo, hi)
    assert torch.equal(lo, _one_level([a, b], 0, 1))


def test_world_of_one_is_the_identity(port_cpu_world):
    x = torch.randn(5)
    assert port.adasum_allreduce(x) is x
    assert torch.equal(port.adasum_allreduce(x, hierarchical=True), x)
    from horovod_tpu_torch.ops.collectives import ProcessSet

    assert port.adasum_allreduce(x, process_set=ProcessSet([0])) is x


@pytest.mark.parametrize("n", [3, 5, 6, 12])
def test_power_of_two_check(n):
    with pytest.raises(ValueError, match="power-of-two"):
        port._check_pow2(n, "rank count")
    port._check_pow2(2 ** (n % 4), "rank count")


def test_hierarchical_adasum_over_a_process_set_raises(port_cpu_world):
    from horovod_tpu_torch.ops.collectives import ProcessSet

    with pytest.raises(NotImplementedError, match="process subset"):
        port.adasum_allreduce(torch.ones(2), process_set=ProcessSet([0]),
                              hierarchical=True)


def _threaded_vhdd(vals, monkeypatch):
    """``_vhdd`` itself on len(vals) ranks, one thread a rank: the
    harness's ``_exchange`` hands each rank its partner's vector of the
    same level (a barrier before and after each exchange)."""
    import threading

    n = len(vals)
    barrier = threading.Barrier(n)
    posted = {}
    me = threading.local()

    def exchange(a, partner):
        posted[me.rank] = a
        barrier.wait()
        b = posted[partner]
        barrier.wait()
        return b

    monkeypatch.setattr(port, "_exchange", exchange)
    out = [None] * n

    def run(r):
        me.rank = r
        out[r] = port._vhdd(vals[r], n, r, lambda lv: r ^ lv)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("dim", [1, 2])
def test_vhdd_on_eight_ranks_matches_the_reference_mesh(monkeypatch, dim,
                                                        cpu_devices):
    """The reference's Adasum on its 8-device CPU mesh against the port's
    recursion on 8 threaded ranks, from the same per-rank inputs: every
    rank bit-identical, and the reference's result to 1e-5."""
    import horovod_tpu as hvd

    rng = np.random.default_rng(40 + dim)
    shape = (64,) if dim == 1 else (8, 8)
    xs = [rng.normal(size=shape).astype(np.float32) for _ in range(8)]
    hvd.shutdown()
    hvd.init(devices=cpu_devices)
    try:
        @hvd.spmd
        def step(x):
            return hvd.allreduce(x[0], op=hvd.Adasum)[None]

        want = [np.asarray(o) for o in hvd.get_per_rank(step(np.stack(xs)))]
    finally:
        hvd.shutdown()
    got = _threaded_vhdd([torch.from_numpy(x) for x in xs], monkeypatch)
    for g in got[1:]:
        assert torch.equal(g, got[0])
    for r in range(8):
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), ref.numpy_adasum(xs),
                               rtol=1e-5, atol=1e-5)
