"""horovod_tpu_torch.parallel.ring_attention against
horovod_tpu.parallel.ring_attention.

One 4-rank gloo job (``tests/torch_dist_worker.py``, task ``ring``),
launched once for the module, runs ring attention (``impl`` ``xla`` and
``flash``, the reference's ``pallas``) and Ulysses (both impls), causal
and not, each rank one block of the sequence, and takes dq, dk, dv of
``sum(out · g)``; then causal ring attention over ``sp`` of a (dp, sp) =
(2, 2) mesh.  The reference runs the same on a 4-device CPU mesh (its
flash ring through ``_ring_pallas_fn`` in interpret mode, as its own
tests run it), its gradients by ``jax.grad`` of the summed loss.

Tolerances: port against reference 1e-5 (float32 both sides, sums in
other orders); against the float64 numpy oracle of
``tests/test_ring_attention.py``, the reference's own 2e-3.  A causal
ring of 4 holds, on every rank but the last, kv shards wholly in the
future of its queries; one hop at such offsets is checked alone too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.ops import flash_attention as ref_fa
from horovod_tpu.parallel import ring_attention as ref_ra
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import ring_attention as ra
from torch_dist_worker import RING_FORMS, RING_IMPLS, launch, ring_inputs

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_TOL = dict(rtol=2e-3, atol=2e-3)
CASES = [(form, impl, causal) for form in RING_FORMS for impl in RING_IMPLS
         for causal in (False, True)]
#: the reference's impl names
REF_IMPL = {"xla": "xla", "flash": "pallas"}


def _full_attention(q, k, v, causal=False):
    """The float64 numpy oracle (tests/test_ring_attention.py:12-24)."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        n = s.shape[-1]
        s = np.where(np.tril(np.ones((n, n), bool))[None, None], s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p = p / p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ring")
    launch("ring", WORLD, workdir, timeout=90)
    return [dict(np.load(workdir / f"ring.{r}.npz")) for r in range(WORLD)]


def _gathered(port_results, key, axis=1):
    return np.concatenate([res[key] for res in port_results], axis=axis)


def _reference(fn, inp, mesh_specs):
    """``fn(q, k, v)`` under a shard_map, in one jitted vjp: the output
    and the gradients of ``sum(out · g)`` over every rank."""
    mesh, spec = mesh_specs
    f = jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                      check_vma=False)

    def out_and_grads(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(g)

    out, grads = jax.jit(out_and_grads)(inp["q"], inp["k"], inp["v"],
                                        inp["g"])
    return {"out": np.asarray(out),
            **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


@pytest.fixture(scope="module")
def reference_results():
    """Every case on the reference's 4-device CPU mesh, and the (dp, sp)
    composition on a (2, 2) one."""
    devs = jax.devices("cpu")
    inp = ring_inputs(WORLD)
    hvd.shutdown()
    hvd.init(devices=devs[:WORLD])
    try:
        with jax.default_device(devs[0]):
            mesh = (Mesh(np.array(devs[:WORLD]), ("sp",)), P(None, "sp"))
            out = {}
            for form, impl, causal in CASES:
                fn = getattr(ref_ra, f"{form}_attention")
                kw = dict(causal=causal, impl=REF_IMPL[impl], axis="sp")
                if form == "ring" and impl == "flash":
                    kw.update(block_q=8, block_k=8)
                out[(form, impl, causal)] = _reference(
                    lambda q, k, v, fn=fn, kw=kw: fn(q, k, v, **kw), inp,
                    mesh)
            inp2 = ring_inputs(2, batch=4, seed=32)
            mesh2 = (Mesh(np.array(devs[:4]).reshape(2, 2), ("dp", "sp")),
                     P("dp", "sp"))
            for impl in RING_IMPLS:
                kw = dict(causal=True, impl=REF_IMPL[impl], axis="sp")
                if impl == "flash":
                    kw.update(block_q=8, block_k=8)
                out[("dp_sp", impl)] = _reference(
                    lambda q, k, v, kw=kw: ref_ra.ring_attention(q, k, v,
                                                                 **kw),
                    inp2, mesh2)
            return out
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("form,impl,causal", CASES)
def test_output_and_grads_match_reference(port_results, reference_results,
                                          form, impl, causal):
    """Ring (``xla``: autograd through the rotation's inverse; ``flash``:
    the reference's ``_ring_pallas_fn`` with dk/dv rotating home) and
    Ulysses, every rank's block of the output and of dq, dk, dv."""
    want = reference_results[(form, impl, causal)]
    for name in ("out", "dq", "dk", "dv"):
        got = _gathered(port_results, f"{form}/{impl}/{int(causal)}/{name}")
        np.testing.assert_allclose(got, want[name], err_msg=name, **TOL)


@pytest.mark.parametrize("form,impl,causal", CASES)
def test_output_matches_float64_oracle(port_results, form, impl, causal):
    inp = ring_inputs(WORLD)
    got = _gathered(port_results, f"{form}/{impl}/{int(causal)}/out")
    np.testing.assert_allclose(got, _full_attention(
        inp["q"], inp["k"], inp["v"], causal), **ORACLE_TOL)


@pytest.mark.parametrize("impl", RING_IMPLS)
def test_dp_sp_matches_reference(port_results, reference_results, impl):
    """Causal ring attention over ``sp`` of a (dp, sp) = (2, 2) mesh, the
    batch over ``dp``: each rank's block (its dp row's half of the batch,
    its sp column's half of the sequence)."""
    want = reference_results[("dp_sp", impl)]
    for name in ("out", "dq", "dk", "dv"):
        rows = [np.concatenate([port_results[2 * row + col][
            f"dp_sp/{impl}/{name}"] for col in range(2)], axis=1)
            for row in range(2)]
        np.testing.assert_allclose(np.concatenate(rows, axis=0), want[name],
                                   err_msg=name, **TOL)


def test_wholly_future_hop_changes_nothing():
    """A causal hop whose kv shard lies wholly in the future of every
    query (owner after this rank): l stays, o and m stay, and dq, dk, dv
    gain exactly 0; the reference's ``mha_partial`` there gives l = 0."""
    rng = np.random.default_rng(7)
    b, h, s, d = 1, 2, 8, 16
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(
        np.float32)) for _ in range(4))
    kw = dict(causal=True, scale=d ** -0.5)
    carry = ra.ring_carry(q)
    ra.ring_fwd_hop(q, k, v, carry, 0, 0, **kw)     # the diagonal first
    before = [t.clone() for t in carry]
    ra.ring_fwd_hop(q, k, v, carry, 0, s, **kw)     # then the future shard
    for got, want in zip(carry, before):
        assert torch.equal(got, want)
    out, lse = ra.ring_finish(carry, q.dtype)
    delta = (do * out).sum(-1, keepdim=True)
    grads = tuple(torch.zeros(b, h, s, d) for _ in range(3))
    ra.ring_bwd_hop(q, k, v, do, lse, delta, grads, 0, s, **kw)
    assert all(float(g.abs().max()) == 0.0 for g in grads)

    with jax.default_device(jax.devices("cpu")[0]):
        _, m, l = ref_fa.mha_partial(*(jnp.asarray(t.numpy())
                                       for t in (q, k, v)), 0, s,
                                     block_q=8, block_k=8, interpret=True,
                                     **kw)
    assert float(np.abs(np.asarray(l)).max()) == 0.0
    po, pm, pl = fa.mha_partial(q, k, v, 0, s, **kw)
    assert float(pl.abs().max()) == 0.0 and torch.isfinite(po).all()
    np.testing.assert_allclose(pm.numpy(), np.asarray(m), rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [24, 40])
def test_lockstep_ring_equals_flash_attention(causal, seq):
    """n virtual ranks in lockstep through the hop functions (what
    chip_smoke.py drives on the card), ragged shard lengths included,
    against flash attention over the whole sequence: outputs and
    gradients."""
    rng = np.random.default_rng(seq)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, seq, 3, 16)).astype(
        np.float32)) for _ in range(4))
    out, dq, dk, dv = ra.ring_lockstep(q, k, v, do, 4 if seq == 24 else 5,
                                       causal=causal)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    want = fa.flash_attention(qq, kk, vv, causal=causal)
    want.backward(do)
    for got, ref in ((out, want.detach()), (dq, qq.grad), (dk, kk.grad),
                     (dv, vv.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fault", ["hop_local_lse", "dropped_hop"])
def test_planted_ring_fault_misses_the_whole_sequence_limits(fault, causal):
    """chip_smoke.py's ring_kernels check in bf16 on the plain hops: the
    sound ring meets the whole-sequence limits (RING_FULL_*) and the ring
    with a hop-local lse, or with a dropped hop, planted in its hop calls
    misses them."""
    import chip_smoke

    rng = np.random.default_rng(7)
    shape, n = (2, 4 * 32, 2, 16), chip_smoke.RING_RANKS
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qq, kk, vv, causal=causal)
    out.backward(do)
    full = (out.detach(), qq.grad, kk.grad, vv.grad)
    seq = shape[1] // n
    limits = (chip_smoke.RING_FULL_ROW_LIMIT, chip_smoke.RING_FULL_MEAN_LIMIT)
    sound = ra.ring_lockstep(q, k, v, do, n, causal=causal)
    assert chip_smoke._ring_errors(sound, full, torch.bfloat16, seq,
                                   limits)[2] == []
    bad = ra.ring_lockstep(q, k, v, do, n, causal=causal,
                           ops=chip_smoke._faulty_hop_ops(ra, fa, fault, seq))
    assert chip_smoke._ring_errors(bad, full, torch.bfloat16, seq,
                                   limits)[2]


def test_world_of_one_equals_local_attention():
    """At one rank the rotation is the identity and sends nothing: every
    form equals local attention (flash for ``flash``, the materialized
    softmax for ``xla``), outputs and gradients."""
    from horovod_tpu_torch import core

    core.shutdown()
    core.init(device="cpu")
    try:
        inp = ring_inputs(1)
        for form in RING_FORMS:
            for impl in RING_IMPLS:
                for causal in (False, True):
                    got = _local(getattr(ra, f"{form}_attention"), inp,
                                 causal=causal, impl=impl)
                    local = fa.flash_attention if impl == "flash" else \
                        fa.softmax_attention
                    want = _local(local, inp, causal=causal)
                    for name in got:
                        np.testing.assert_allclose(got[name], want[name],
                                                   err_msg=name, **TOL)
    finally:
        core.shutdown()


def _local(fn, inp, **kw):
    q, k, v = (torch.from_numpy(inp[n]).requires_grad_() for n in "qkv")
    out = fn(q, k, v, **kw)
    (out * torch.from_numpy(inp["g"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def test_ulysses_needs_heads_divisible_by_ranks(port_results):
    """3 heads over 4 ranks raises before any exchange (every rank)."""
    assert all(bool(res["ulysses_heads_error"]) for res in port_results)


def test_hop_offsets_are_host_ints():
    """The flash ring's offsets are Python ints from the rank and the hop
    (no device scalar): each hop's (q_offset, kv_offset) recorded."""
    seen = []

    def partial(q, k, v, q_offset, kv_offset, **kw):
        seen.append((q_offset, kv_offset))
        return ra.HOP_KERNELS.partial(q, k, v, q_offset, kv_offset, **kw)

    ops = ra.HopOps(partial, ra.HOP_KERNELS.bwd_dq, ra.HOP_KERNELS.bwd_dkv)
    q = torch.zeros(1, 12, 2, 16)
    ra.ring_lockstep(q, q, q, q, 3, causal=True, ops=ops)
    assert all(type(a) is int and type(b) is int for a, b in seen)
    assert seen == [(r * 4, ((r - hop) % 3) * 4) for hop in range(3)
                    for r in range(3)]
