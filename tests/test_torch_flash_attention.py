"""horovod_tpu_torch.ops.flash_attention against
horovod_tpu.ops.flash_attention on the same seeded numpy inputs.

On the CPU the port runs the plain versions of K2-K4; the reference runs
its Pallas kernels in interpret mode on the CPU, as
tests/test_flash_attention.py does (with 16-row blocks, where the plain
forward's online softmax runs over the kernels' 64-key tiles).
Tolerance 2e-4, the reference tests' own against a dense oracle: both
sides sum in float32, in other orders.  In bf16, at equal tiles, the
plain forward rounds p where the Pallas body does, and its o is within
one bf16 ulp of the body's.  The kernels themselves run only on the
card: their tests are marked ``cuda`` and skip here (``python3
chip_smoke.py`` holds them against the plain versions there, at GPT-2
small's shapes too).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as ref
from horovod_tpu_torch import kernels
from horovod_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)
BLOCKS = dict(block_q=16, block_k=16, interpret=True)


@pytest.fixture(autouse=True)
def _on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _inputs(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.normal(size=(b, s, h, d)).astype(np.float32)
    return mk(sq), mk(sk), mk(sk), mk(sq)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("seq", [64, 136, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_forward_and_grads_match_reference(seq, causal):
    q, k, v, g = _inputs(seq, 2, seq, seq, 2, 16)

    def ref_loss(q, k, v):
        o = ref.flash_attention(q, k, v, causal=causal, **BLOCKS)
        return (o * g).sum(), o

    (_, want), grads = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), _t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    for name, a, b in zip("qkv", got_grads, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("q_off,kv_off", [(32, 0), (64, 16), (0, 40)])
def test_flash_attention_offsets_match_reference(q_off, kv_off):
    q, k, v, g = _inputs(7, 1, 48, 80, 2, 16)

    def ref_loss(q, k, v):
        o = ref.flash_attention(q, k, v, causal=True, q_offset=q_off,
                                kv_offset=kv_off, **BLOCKS)
        return (o * g).sum(), o

    (_, want), grads = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    got = fa.flash_attention(tq, tk, tv, causal=True, q_offset=q_off,
                             kv_offset=kv_off)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), _t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    for a, b in zip(got_grads, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _bhsd(*arrays):
    return [np.ascontiguousarray(np.swapaxes(a, 1, 2)) for a in arrays]


@pytest.mark.parametrize("q_off,kv_off", [(0, 0), (64, 16), (16, 48),
                                          (0, 1024)])
def test_ring_building_blocks_match_reference(q_off, kv_off):
    """mha_partial's unnormalized (o, m, l), then mha_bwd_dq and
    mha_bwd_dkv with the reference's lse and delta; (0, 1024) is a kv
    shard wholly in the future of every row."""
    q, k, v, do = _bhsd(*_inputs(11, 2, 32, 48, 2, 16))
    scale = 0.25
    o, m, l = ref.mha_partial(q, k, v, q_off, kv_off, causal=True,
                              scale=scale, **BLOCKS)
    got = fa.mha_partial(_t(q), _t(k), _t(v), q_off, kv_off, causal=True,
                         scale=scale)
    for a, b in zip(got, (o, m, l)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if kv_off > q_off + 31:
        assert np.isfinite(got[0].numpy()).all()
        np.testing.assert_array_equal(got[2].numpy(), 0.0)
        return
    lse = np.asarray(m + jnp.log(jnp.maximum(l, 1e-30)))
    delta = np.sum(do * (np.asarray(o) / np.maximum(np.asarray(l), 1e-30)),
                   axis=-1, keepdims=True).astype(np.float32)
    args = (q, k, v, do, lse, delta, q_off, kv_off)
    dq = ref.mha_bwd_dq(*args, causal=True, scale=scale, **BLOCKS)
    dk, dv = ref.mha_bwd_dkv(*args, causal=True, scale=scale, **BLOCKS)
    targs = [_t(a) for a in args[:6]] + [q_off, kv_off]
    np.testing.assert_allclose(
        fa.mha_bwd_dq(*targs, causal=True, scale=scale).numpy(),
        np.asarray(dq), **TOL)
    got_dk, got_dv = fa.mha_bwd_dkv(*targs, causal=True, scale=scale)
    np.testing.assert_allclose(got_dk.numpy(), np.asarray(dk), **TOL)
    np.testing.assert_allclose(got_dv.numpy(), np.asarray(dv), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_softmax_attention_matches_reference(causal):
    q, k, v, _ = _inputs(5, 2, 40, 40, 3, 8)
    want = ref.softmax_attention(q, k, v, causal=causal)
    got = fa.softmax_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_bf16_casts_follow_the_kernel_body():
    """In bf16 the plain forward rounds each kv tile's p to v's dtype
    against the running max before p·v and returns o in q's dtype with
    float32 m and l, as the Pallas body does: at the body's 64-row blocks
    over three kv tiles, its o is within one bf16 ulp (2^-7 relative) of
    the reference's in interpret mode."""
    q, k, v, _ = _bhsd(*_inputs(3, 1, 192, 192, 2, 16))
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                  for a in (qb, kb, vb))
    for causal in (True, False):
        o, m, l = fa.plain_mha_fwd(qb, kb, vb, causal=causal, scale=0.25)
        assert (o.dtype, m.dtype, l.dtype) == (
            torch.bfloat16, torch.float32, torch.float32)
        ro, rm, rl = ref._mha_fwd(jq, jk, jv, ref._offsets(0, 0),
                                  causal=causal, scale=0.25, block_q=64,
                                  block_k=fa.KV_TILE, normalize=True,
                                  interpret=True)
        np.testing.assert_allclose(m.numpy(), np.asarray(rm), **TOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(rl), **TOL)
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(ro.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-5)


def test_plain_flash_attention_is_flash_attention_on_cpu():
    """The oracle takes the same plain versions as flash_attention does
    on CPU tensors, forward and backward, and launches nothing."""
    q, k, v, g = (_t(a) for a in _inputs(4, 2, 80, 80, 2, 32))
    before = dict(kernels.flash_launches)
    outs = []
    for fn in (fa.flash_attention, fa.plain_flash_attention):
        tq, tk, tv = (a.clone().requires_grad_() for a in (q, k, v))
        o = fn(tq, tk, tv, causal=True)
        outs.append((o, *torch.autograd.grad(o, (tq, tk, tv), g)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert kernels.flash_launches == before


def test_kernel_wrappers_raise_instead_of_falling_back():
    """A non-CPU tensor goes to K2-K4 or raises: meta tensors (standing in
    for card tensors) fail the wrapper's checks before any build."""
    before = dict(kernels.flash_launches)
    q = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q, causal=True)
    qt = q.transpose(1, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.mha_partial(qt, qt, qt, 0, 0, causal=True, scale=0.125)
    stats = torch.empty(1, 2, 8, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.mha_bwd_dkv(qt, qt, qt, qt, stats, stats, 0, 0, causal=True,
                       scale=0.125)
    assert kernels.flash_launches == before


@pytest.mark.parametrize("q,match", [
    (torch.empty(1, 2, 8, 64, dtype=torch.float16, device="meta"),
     "float32 or bfloat16"),
    (torch.empty(1, 2, 8, 48, device="meta"), "head dim 48"),
    (torch.empty(1, 2, 8, device="meta"), r"\[b, h, s, d\]"),
    (torch.empty(1, 2, 8, 128, device="meta")[..., ::2],
     "head dim is contiguous"),
])
def test_kernel_checks_refuse_what_k2_k4_do_not_take(q, match):
    with pytest.raises((TypeError, ValueError), match=match):
        kernels._check_flash(q, q, q)


def test_kernel_checks_refuse_bad_row_statistics():
    q = torch.empty(1, 2, 8, 64, device="meta")
    lse = torch.empty(1, 2, 8, 1, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse and delta"):
        kernels._check_flash(q, q, q, q, (lse, lse))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [136, 192])
def test_kernels_match_plain_versions_on_card(causal, seq, dtype):
    """K2, K3 and K4 on the card against their plain versions at ragged
    lengths: float32 (the scalar kernels) to 2e-4, bf16 (the tensor-core
    kernels) row by row in norm, chip_smoke.py's FLASH_BF16_ROW_LIMIT:
    the plain forward rounds p per kv tile as the kernel does."""
    if not torch.cuda.is_available():
        pytest.skip("K2-K4 are CUDA C++ and run only on an NVIDIA card "
                    "(python3 chip_smoke.py runs them there)")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seq)
    q, k, v, do = (torch.randn(2, 3, seq, 64, device="cuda", generator=gen)
                   .to(dt) for _ in range(4))
    kw = dict(causal=causal, scale=1 / math.sqrt(64), q_offset=0,
              kv_offset=0)
    before = dict(kernels.flash_launches)
    o, m, l = fa._mha_fwd(q, k, v, normalize=True, **kw)
    po, pm, pl = fa.plain_mha_fwd(q, k, v, **kw)
    lse = pm + torch.log(pl.clamp_min(1e-30))
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dq = fa._mha_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa._mha_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert {n: kernels.flash_launches[n] - before[n] for n in before} == \
        {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    import chip_smoke

    for name, a, b in (
            ("o", o, po), ("m", m, pm), ("l", l, pl),
            ("dq", dq, fa.plain_mha_bwd_dq(q, k, v, do, lse, delta, **kw)),
            *zip(("dk", "dv"), (dk, dv),
                 fa.plain_mha_bwd_dkv(q, k, v, do, lse, delta, **kw))):
        a, b = a.float(), b.float()
        if dt == torch.float32:
            torch.testing.assert_close(a, b, **TOL)
        else:
            top, mean = chip_smoke.row_rel_err(a, b)
            assert top <= chip_smoke.FLASH_BF16_ROW_LIMIT[name], name
            assert mean <= chip_smoke.FLASH_BF16_MEAN_LIMIT, name
