"""horovod_tpu_torch.ops.flash_attention against
horovod_tpu.ops.flash_attention on the same seeded numpy inputs.

On the CPU the port runs the plain versions of K2-K4; the reference runs
its Pallas kernels in interpret mode on the CPU, as
tests/test_flash_attention.py does (with 16-row blocks, where the plain
forward's online softmax runs over 64-key tiles by default, or over the
128-key tiles of the TMA + wgmma K2 when asked).  Tolerance 2e-4, the
reference tests' own against a dense oracle: both sides sum in float32,
in other orders.  In bf16, at equal tiles, the plain forward rounds p
where the Pallas body does, and its o is within one bf16 ulp of the
body's.  ``kernels.flash_plan``, the rule that picks each launch's
mainloop, is pure Python and tested here.  The kernels themselves run
only on the card: their tests are marked ``cuda`` and skip here
(``python3 chip_smoke.py`` holds them against the plain versions there,
at GPT-2 small's shapes too).
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


@pytest.mark.parametrize("q_off,kv_off", [(0, 48), (0, 16), (100, 120)])
def test_bwd_dq_of_rows_that_see_no_key_is_zero(q_off, kv_off):
    """mha_bwd_dq where every row of the q shard sees no key (kv_off 48:
    the kv shard wholly in its future) or only the first rows see none:
    the port's dq against the reference's in interpret mode, 2e-4, and
    exactly 0 on every row that sees no key, on both sides (the TMA +
    wgmma K3 must store those zeros: its output is not initialised)."""
    q, k, v, do = _bhsd(*_inputs(q_off + kv_off, 2, 32, 48, 2, 16))
    scale = 0.25
    o, m, l = ref.mha_partial(q, k, v, q_off, kv_off, causal=True,
                              scale=scale, **BLOCKS)
    l = np.maximum(np.asarray(l), 1e-30)
    lse = np.asarray(m) + np.log(l)
    delta = np.sum(do * (np.asarray(o) / l), axis=-1,
                   keepdims=True).astype(np.float32)
    args = (q, k, v, do, lse.astype(np.float32), delta)
    want = np.asarray(ref.mha_bwd_dq(*args, q_off, kv_off, causal=True,
                                     scale=scale, **BLOCKS))
    got = fa.mha_bwd_dq(*(_t(a) for a in args), q_off, kv_off, causal=True,
                        scale=scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    blind = q_off + np.arange(32) < kv_off
    assert blind.any()
    np.testing.assert_array_equal(got[:, :, blind], 0.0)
    np.testing.assert_array_equal(want[:, :, blind], 0.0)


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
    tile = kernels.flash_plan_for("fwd", q, k, v).kv_tile
    po, pm, pl = fa.plain_mha_fwd(q, k, v, kv_tile=tile, **kw)
    lse = pm + torch.log(pl.clamp_min(1e-30))
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dq = fa._mha_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa._mha_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    import chip_smoke

    loops = chip_smoke.GPT_F32_FLASH if dt == torch.float32 else \
        chip_smoke.GPT_BF16_FLASH
    assert {n: kernels.flash_launches[n] - before[n] for n in before} == \
        chip_smoke.flash_counts(kernels, loops, 1)

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


# ---------------------------------------------------------------------------
# kernels.flash_plan: which mainloop each launch takes
# ---------------------------------------------------------------------------
#: [b, h, s, d] strides (elements) of GPT-2 small's [b, s, h, d]
#: activations seen as [b, h, s, d], and of contiguous [b, h, s, d]
GPT_STRIDES = (1024 * 12 * 64, 64, 12 * 64)
BHSD_STRIDES = (3 * 136 * 64, 136 * 64, 64)


def _ops(n, ptr=4096, strides=BHSD_STRIDES):
    return [(ptr + 65536 * i, strides) for i in range(n)]


@pytest.mark.parametrize("kind,dtype,d,lengths,ops,want", [
    ("fwd", torch.bfloat16, 64, (1024, 1024), _ops(3, strides=GPT_STRIDES),
     ("wgmma", 128, 128)),
    ("bwd_dkv", torch.bfloat16, 64, (1024, 1024),
     _ops(4, strides=GPT_STRIDES), ("wgmma", 64, 128)),
    ("bwd_dq", torch.bfloat16, 64, (1024, 1024),
     _ops(4, strides=GPT_STRIDES), ("wgmma", 128, 64)),
    ("fwd", torch.bfloat16, 64, (136, 192), _ops(3), ("wgmma", 128, 128)),
    ("fwd", torch.bfloat16, 64, (136, 136), _ops(3, ptr=4098),
     ("mma_sync", 64, 64)),
    ("bwd_dkv", torch.bfloat16, 64, (136, 136),
     _ops(3) + [(4098, BHSD_STRIDES)], ("mma_sync", 64, 64)),
    ("bwd_dq", torch.bfloat16, 64, (136, 136),
     _ops(3) + [(4098, BHSD_STRIDES)], ("mma_sync", 64, 64)),
    ("fwd", torch.bfloat16, 64, (136, 136),
     _ops(3, strides=(3 * 136 * 68, 136 * 68, 68)), ("mma_sync", 64, 64)),
    ("fwd", torch.bfloat16, 64, (136, 136),
     _ops(3, strides=(0, 136 * 64, 64)), ("mma_sync", 64, 64)),
    ("fwd", torch.bfloat16, 64, (136, 0), _ops(3), ("mma_sync", 64, 64)),
    ("bwd_dq", torch.bfloat16, 64, (136, 0), _ops(4), ("mma_sync", 64, 64)),
    ("fwd", torch.bfloat16, 16, (136, 136), _ops(3), ("mma_sync", 64, 64)),
    ("fwd", torch.bfloat16, 32, (136, 136), _ops(3), ("mma_sync", 64, 64)),
    ("fwd", torch.bfloat16, 128, (136, 136), _ops(3), ("mma_sync", 64, 64)),
    ("bwd_dkv", torch.bfloat16, 128, (136, 136), _ops(4),
     ("mma_sync", 64, 64)),
    ("bwd_dq", torch.bfloat16, 128, (136, 136), _ops(4),
     ("mma_sync", 64, 64)),
    ("fwd", torch.float32, 64, (1024, 1024), _ops(3, strides=GPT_STRIDES),
     ("f32", 64, 64)),
    ("bwd_dkv", torch.float32, 64, (136, 136), _ops(4), ("f32", 64, 64)),
], ids=["gpt2-fwd", "gpt2-dkv", "gpt2-dq", "ragged", "misaligned",
        "misaligned-do", "misaligned-do-dq", "stride-68", "stride-0",
        "no-keys", "no-keys-dq", "d16", "d32", "d128-fwd", "d128-dkv",
        "d128-dq", "float32", "float32-dkv"])
def test_flash_dispatch_rule(kind, dtype, d, lengths, ops, want):
    """bf16 K2, K3 and K4 at head dim 64 whose every copied operand TMA
    can address take the TMA + wgmma mainloop (K3 on 128-row q tiles and
    64-key kv tiles); other bf16 operands mma.sync; float32 the scalar
    kernels."""
    assert tuple(kernels.flash_plan(kind, dtype, d, lengths, ops)) == want


def test_flash_plan_reads_the_operands_as_the_wrappers_pass_them():
    """flash_plan_for reads pointers and strides off real tensors: GPT's
    [b, s, h, d] activations seen as [b, h, s, d] take wgmma, a view one
    element past an aligned buffer mma.sync."""
    x = torch.zeros(2, 136, 3, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert kernels.flash_plan_for("fwd", x, x, x).mainloop == "wgmma"
    assert kernels.flash_plan_for("bwd_dkv", x, x, x, x).mainloop == "wgmma"
    assert kernels.flash_plan_for("bwd_dq", x, x, x, x).mainloop == "wgmma"
    buf = torch.zeros(2 * 3 * 136 * 64 + 1, dtype=torch.bfloat16)
    off = buf[1:].view(2, 3, 136, 64)
    assert buf.data_ptr() % 16 == 0 and off.data_ptr() % 16
    assert kernels.flash_plan_for("fwd", off, x, x).mainloop == "mma_sync"
    assert kernels.flash_plan_for("bwd_dkv", x, x, x, off).mainloop == \
        "mma_sync"
    assert kernels.flash_plan_for("bwd_dq", x, x, x, off).mainloop == \
        "mma_sync"
    assert kernels.flash_plan_for("fwd", x, x, x,
                                  mainloop="mma_sync").mainloop == "mma_sync"


@pytest.mark.parametrize("kind,dtype,mainloop,error", [
    ("fwd", torch.bfloat16, "wgmma", ValueError),
    ("fwd", torch.float32, "mma_sync", ValueError),
    ("fwd", torch.float16, None, TypeError),
    ("bwd", torch.bfloat16, None, ValueError),
    ("bwd_dq", torch.bfloat16, "wgmma", ValueError),
    ("bwd_dq", torch.float32, "mma_sync", ValueError),
])
def test_flash_plan_refuses_what_it_cannot_give(kind, dtype, mainloop, error):
    """Only the mma.sync mainloop may be asked for, on bf16 alone: the
    TMA + wgmma one is the rule's to give."""
    with pytest.raises(error):
        kernels.flash_plan(kind, dtype, 64, (136, 136), _ops(3), mainloop)


def test_flash_launch_counts_are_keyed_by_kind_and_mainloop():
    """One counter, ``kind.mainloop``, every kind on each of the three
    mainloops; launch_totals sums a kind's mainloops."""
    assert set(kernels.flash_launches) == {
        "fwd.wgmma", "fwd.mma_sync", "fwd.f32", "bwd_dq.wgmma",
        "bwd_dq.mma_sync", "bwd_dq.f32", "bwd_dkv.wgmma", "bwd_dkv.mma_sync",
        "bwd_dkv.f32"}
    counts = dict.fromkeys(kernels.flash_launches, 0)
    counts.update({"fwd.wgmma": 12, "fwd.mma_sync": 1, "bwd_dq.wgmma": 12,
                   "bwd_dq.mma_sync": 3, "bwd_dkv.wgmma": 12,
                   "bwd_dkv.f32": 2})
    assert kernels.launch_totals(counts) == {"fwd": 13, "bwd_dq": 15,
                                             "bwd_dkv": 14}


def test_flash_launch_hands_the_plan_to_the_kernel(monkeypatch):
    """The wrappers pass their plan's mainloop in HvdFlashArgs and count
    the launch under its kind and mainloop (meta tensors stand in for
    card tensors; nothing is launched)."""
    seen = []
    monkeypatch.setattr(kernels, "_check_on_card", lambda *a: None)
    monkeypatch.setattr(kernels, "_launch",
                        lambda fn, counts, key, dev, args:
                        seen.append((fn, counts is kernels.flash_launches,
                                     key, args._obj.mainloop)))
    q = torch.empty(4, 1024, 12, 64, dtype=torch.bfloat16,
                    device="meta").transpose(1, 2)
    stats = torch.empty(4, 12, 1024, 1, device="meta")
    kw = dict(causal=True, scale=0.125)
    kernels.launch_flash_fwd(q, q, q, **kw)
    kernels.launch_flash_bwd_dq(q, q, q, q, stats, stats, **kw)
    kernels.launch_flash_bwd_dkv(q, q, q, q, stats, stats, **kw)
    kernels.launch_flash_fwd(q, q, q, **kw, mainloop="mma_sync")
    kernels.launch_flash_bwd_dq(q, q, q, q, stats, stats, **kw,
                                mainloop="mma_sync")
    kernels.launch_flash_bwd_dkv(q, q, q, q, stats, stats, **kw,
                                 mainloop="mma_sync")
    qf = q.float()
    kernels.launch_flash_fwd(qf, qf, qf, **kw)
    assert seen == [
        ("hvd_flash_fwd", True, "fwd.wgmma", 1),
        ("hvd_flash_bwd_dq", True, "bwd_dq.wgmma", 1),
        ("hvd_flash_bwd_dkv", True, "bwd_dkv.wgmma", 1),
        ("hvd_flash_fwd", True, "fwd.mma_sync", 0),
        ("hvd_flash_bwd_dq", True, "bwd_dq.mma_sync", 0),
        ("hvd_flash_bwd_dkv", True, "bwd_dkv.mma_sync", 0),
        ("hvd_flash_fwd", True, "fwd.f32", 0)]
    with pytest.raises(ValueError, match="mma_sync"):
        kernels.launch_flash_fwd(qf, qf, qf, **kw, mainloop="mma_sync")


@pytest.mark.parametrize("kind", ["fwd", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("dtype,mainloop", [(torch.bfloat16, "wgmma"),
                                            (torch.bfloat16, "f32"),
                                            (torch.float32, "mma_sync")])
def test_flash_wrappers_take_mma_sync_on_bf16_alone(monkeypatch, kind,
                                                    dtype, mainloop):
    """Each of launch_flash_fwd, launch_flash_bwd_dq and
    launch_flash_bwd_dkv refuses any mainloop but mma_sync, and that one
    on float32, before it launches anything."""
    monkeypatch.setattr(kernels, "_check_on_card", lambda *a: None)
    monkeypatch.setattr(kernels, "_launch", lambda *a: pytest.fail(a))
    q = torch.empty(2, 64, 3, 64, dtype=dtype, device="meta").transpose(1, 2)
    stats = torch.empty(2, 3, 64, 1, device="meta")
    kw = dict(causal=True, scale=0.125, mainloop=mainloop)
    launch = {"fwd": lambda: kernels.launch_flash_fwd(q, q, q, **kw),
              "bwd_dq": lambda: kernels.launch_flash_bwd_dq(
                  q, q, q, q, stats, stats, **kw),
              "bwd_dkv": lambda: kernels.launch_flash_bwd_dkv(
                  q, q, q, q, stats, stats, **kw)}[kind]
    with pytest.raises(ValueError, match="mma_sync"):
        launch()


# ---------------------------------------------------------------------------
# the plain forward at the TMA + wgmma K2's 128-key tile
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [136, 192, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_at_the_wgmma_tile_matches_reference(seq, causal):
    """flash_attention through the plain versions with the forward's
    online softmax over 128-key tiles: the same o and gradients as the
    reference's interpret-mode kernels, float32, 2e-4."""
    q, k, v, g = _inputs(seq + 1, 2, seq, seq, 2, 64)

    def ref_loss(q, k, v):
        o = ref.flash_attention(q, k, v, causal=causal, **BLOCKS)
        return (o * g).sum(), o

    (_, want), grads = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    got = fa.plain_flash_attention(tq, tk, tv, causal=causal, kv_tile=128)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), _t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    for name, a, b in zip("qkv", got_grads, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("q_off,kv_off", [(128, 64), (64, 200), (0, 136),
                                          (300, 0)])
def test_plain_partial_at_the_wgmma_tile_matches_reference(q_off, kv_off):
    """mha_partial's unnormalized (o, m, l) from the plain forward over
    128-key tiles, at chip_smoke.py's case (c) offsets, against the
    reference's mha_partial in interpret mode: float32, 2e-4; a kv shard
    wholly in the future leaves l exactly 0."""
    q, k, v, _ = _bhsd(*_inputs(q_off + kv_off, 2, 136, 200, 2, 64))
    o, m, l = ref.mha_partial(q, k, v, q_off, kv_off, causal=True,
                              scale=0.125, **BLOCKS)
    got = fa.plain_mha_fwd(_t(q), _t(k), _t(v), causal=True, scale=0.125,
                           q_offset=q_off, kv_offset=kv_off,
                           normalize=False, kv_tile=128)
    for a, b in zip(got, (o, m, l)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if kv_off > q_off + 135:
        np.testing.assert_array_equal(got[2].numpy(), 0.0)


@pytest.mark.parametrize("seq", [256, 384])
@pytest.mark.parametrize("d", [16, 64])
def test_plain_bf16_casts_at_the_wgmma_tile_follow_the_kernel_body(seq, d):
    """The bf16 check of test_plain_bf16_casts_follow_the_kernel_body at
    the 128-key tile: the plain forward and the Pallas body at block_k
    128 both round each tile's p against the running max.  At that test's
    head dim 16, o agrees elementwise within one bf16 ulp (2^-7 relative,
    atol 1e-5); at GPT-2's 64 the scores' float32 sums run over more
    terms in other orders, a few p round the other way and move an o
    element near 0 by more than its own ulp, so o is held row by row in
    norm, to chip_smoke.py's one-ulp FLASH_BF16_ROW_LIMIT and its mean."""
    import chip_smoke

    q, k, v, _ = _bhsd(*_inputs(seq, 1, seq, seq, 2, d))
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                  for a in (qb, kb, vb))
    scale = 1 / math.sqrt(d)
    for causal in (True, False):
        o, m, l = fa.plain_mha_fwd(qb, kb, vb, causal=causal, scale=scale,
                                   kv_tile=128)
        ro, rm, rl = ref._mha_fwd(jq, jk, jv, ref._offsets(0, 0),
                                  causal=causal, scale=scale, block_q=128,
                                  block_k=128, normalize=True,
                                  interpret=True)
        np.testing.assert_allclose(m.numpy(), np.asarray(rm), **TOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(rl), **TOL)
        want = np.asarray(ro.astype(jnp.float32))
        if d == 16:
            np.testing.assert_allclose(o.float().numpy(), want,
                                       rtol=2 ** -7, atol=1e-5)
        else:
            top, mean = chip_smoke.row_rel_err(o, torch.tensor(want))
            assert top <= chip_smoke.FLASH_BF16_ROW_LIMIT["o"], top
            assert mean <= chip_smoke.FLASH_BF16_MEAN_LIMIT, mean


# ---------------------------------------------------------------------------
# the TMA + wgmma K2, K3 and K4 on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout,causal,offsets,normalize", [
    ((4, 12, 1024, 1024), "bshd", True, (0, 0), True),
    ((2, 3, 136, 136), "bhsd", True, (0, 0), True),
    ((2, 3, 192, 192), "bhsd", False, (0, 0), True),
    ((2, 3, 136, 192), "bhsd", True, (0, 0), True),
    ((2, 3, 136, 72), "bhsd", True, (128, 64), False),
    ((2, 3, 136, 72), "bhsd", True, (64, 200), False),
    ((2, 3, 136, 72), "bhsd", True, (0, 136), False),
    ((1, 2, 200, 136), "bhsd", True, (300, 0), False),
], ids=["gpt2", "ragged136", "ragged192", "ragged136x192", "offsets-a",
        "offsets-b", "future-shard", "offsets-c"])
def test_wgmma_kernels_match_plain_versions_on_card(shape, layout, causal,
                                                    offsets, normalize):
    """K2, K3 and K4 on the TMA + wgmma mainloop (checked by the counts)
    against their plain versions, the forward at the plan's 128-key tile:
    GPT-2 small's shape in the model's layout, ragged lengths, chip_smoke
    .py's case (c) offsets unnormalized; bf16 row by row in norm at
    chip_smoke.py's limits; a q shard that sees no key gives dq exactly
    0."""
    if not torch.cuda.is_available():
        pytest.skip("K2-K4 are CUDA C++ and run only on an NVIDIA card "
                    "(python3 chip_smoke.py runs them there)")
    import chip_smoke

    b, h, sq, sk = shape
    q, k, v, do = chip_smoke._flash_inputs(b, h, sq, sk, 64, torch.bfloat16,
                                           sq + sk, layout)
    kw = dict(causal=causal, scale=0.125, q_offset=offsets[0],
              kv_offset=offsets[1])
    plan = kernels.flash_plan_for("fwd", q, k, v)
    assert plan == kernels.FlashPlan("wgmma", 128, 128)
    before = dict(kernels.flash_launches)
    got = dict(zip("oml", fa._mha_fwd(q, k, v, normalize=normalize, **kw)))
    want = dict(zip("oml", fa.plain_mha_fwd(q, k, v, normalize=normalize,
                                            kv_tile=plan.kv_tile, **kw)))
    po, pm, pl = fa.plain_mha_fwd(q, k, v, kv_tile=plan.kv_tile, **kw)
    lse = pm + torch.log(pl.clamp_min(1e-30))
    delta = (do.float() * po.float()).sum(-1, keepdim=True).contiguous()
    got.update(zip(("dk", "dv"), fa._mha_bwd_dkv(q, k, v, do, lse, delta,
                                                 **kw)))
    want.update(zip(("dk", "dv"), fa.plain_mha_bwd_dkv(q, k, v, do, lse,
                                                       delta, **kw)))
    got["dq"] = fa._mha_bwd_dq(q, k, v, do, lse, delta, **kw)
    want["dq"] = fa.plain_mha_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert {n: kernels.flash_launches[n] - before[n] for n in before} == \
        chip_smoke.flash_counts(kernels, chip_smoke.GPT_BF16_FLASH, 1)
    for name in got:
        top, mean = chip_smoke.row_rel_err(got[name], want[name])
        assert top <= chip_smoke.FLASH_BF16_ROW_LIMIT[name], (name, top)
        assert mean <= chip_smoke.FLASH_BF16_MEAN_LIMIT, (name, mean)
    if offsets[1] > offsets[0] + sq - 1:
        assert got["l"].abs().max().item() == 0.0
        assert got["dq"].abs().max().item() == 0.0


@pytest.mark.cuda
def test_wgmma_and_mma_sync_mainloops_agree_on_card():
    """At GPT-2 small's shape the mma.sync K2, K3 and K4, asked for by
    name, against the plain versions at their own 64-key tile: the
    yardstick chip_smoke.py times beside the new mainloop computes the
    same function."""
    if not torch.cuda.is_available():
        pytest.skip("K2-K4 are CUDA C++ and run only on an NVIDIA card "
                    "(python3 chip_smoke.py runs them there)")
    import chip_smoke

    q, k, v, do = chip_smoke._flash_inputs(4, 12, 1024, 1024, 64,
                                           torch.bfloat16, 5, "bshd")
    kw = dict(causal=True, scale=0.125)
    o, m, l = kernels.launch_flash_fwd(q, k, v, **kw, mainloop="mma_sync")
    po, pm, pl = fa.plain_mha_fwd(q, k, v, kv_tile=64, **kw)
    lse = pm + torch.log(pl.clamp_min(1e-30))
    delta = (do.float() * po.float()).sum(-1, keepdim=True).contiguous()
    dk, dv = kernels.launch_flash_bwd_dkv(q, k, v, do, lse, delta, **kw,
                                          mainloop="mma_sync")
    pdk, pdv = fa.plain_mha_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = kernels.launch_flash_bwd_dq(q, k, v, do, lse, delta, **kw,
                                     mainloop="mma_sync")
    pdq = fa.plain_mha_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for name, a, b in (("o", o, po), ("l", l, pl), ("dk", dk, pdk),
                       ("dv", dv, pdv), ("dq", dq, pdq)):
        top, mean = chip_smoke.row_rel_err(a, b)
        assert top <= chip_smoke.FLASH_BF16_ROW_LIMIT[name], (name, top)
        assert mean <= chip_smoke.FLASH_BF16_MEAN_LIMIT, (name, mean)
