"""horovod_tpu_torch.ops.conv_bn against horovod_tpu.ops.conv_bn (the
Pallas kernels in interpret mode, ``interpret=True``, as the JAX
package's own tests run them), and the port's ``PallasConvBN3x3`` against
the reference's module.

Tolerances are the JAX tests' own (tests/test_conv_bn.py): 1e-4 for the
conv outputs and the train forward's statistics (1e-3 absolute for the
sums, 1e-3 for the variance and the output), 5e-2 in bf16, and 2e-3 for
the train gradients dx, dw, dgamma and dbeta.  Both sides sum float32
products in other orders.  On the CPU the port runs the kernels' plain
versions (the nine shift-and-matmul taps of the reference's
``_conv_taps``); the kernels themselves are held to those on the card
(the test marked ``cuda`` here, and ``python3 chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import conv_bn as ref
from horovod_tpu_torch import kernels
from horovod_tpu_torch.models.resnet import PallasConvBN3x3
from horovod_tpu_torch.ops import conv_bn as cb


def _data(b=3, h=8, w=8, cin=16, cout=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, cin)).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, size=(cout,)).astype(np.float32),
            rng.normal(size=(cout,)).astype(np.float32))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


#: the JAX tests' square case, their rectangular one (Cin 8 -> Cout 24),
#: and odd spatial sizes with C = 24 (not a multiple of 16)
CASES = {"square": {}, "rectangular": {"cin": 8, "cout": 24},
         "odd": {"b": 2, "h": 9, "w": 7, "cin": 24, "cout": 24}}


@pytest.mark.parametrize("case", list(CASES))
def test_conv_bn_relu_matches_reference(case):
    x, k, scale, bias = _data(**CASES[case])
    got = cb.conv3x3_bn_relu(_t(x), _t(k), _t(scale), _t(bias))
    want = ref.conv3x3_bn_relu(x, k, scale, bias, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_conv_stats_matches_reference(case):
    x, k, *_ = _data(**{"b": 4, **CASES[case]})
    y, s, sq = cb.conv3x3_stats(_t(x), _t(k))
    wy, ws, wsq = ref.conv3x3_stats(x, k, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(sq.numpy(), np.asarray(wsq), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_conv_plain_matches_reference(case):
    x, k, *_ = _data(**CASES[case])
    got = cb.conv3x3_plain(_t(x), _t(k))
    want = ref.conv3x3_plain(x, k, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_conv_bn_relu_bf16():
    x, k, scale, bias = _data()
    got = cb.conv3x3_bn_relu(_t(x).bfloat16(), _t(k).bfloat16(), _t(scale),
                             _t(bias))
    want = ref.conv3x3_bn_relu(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(k, jnp.bfloat16), scale, bias,
                               interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


def test_stats_sum_the_float32_accumulator():
    """K9 sums acc, not the rounded y: in bf16 the sums match the
    reference's kernel to float32 rounding, while sums of the bf16 y
    would be off by bf16 rounding."""
    x, k, *_ = _data(b=2, seed=3)
    xb, kb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    y, s, sq = cb.conv3x3_stats(_t(np.asarray(xb, np.float32)).bfloat16(),
                                _t(np.asarray(kb, np.float32)).bfloat16())
    _, ws, wsq = ref.conv3x3_stats(xb, kb, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(sq.numpy(), np.asarray(wsq), rtol=1e-5)
    from_y = y.float().sum(dim=(0, 1, 2))
    assert not torch.allclose(from_y, s, rtol=1e-5, atol=1e-4)


def test_shape_validation():
    x, k, scale, bias = _data()
    with pytest.raises(ValueError, match="NHWC"):
        cb.conv3x3_bn_relu(_t(x)[0], _t(k), _t(scale), _t(bias))
    with pytest.raises(ValueError, match="NHWC"):
        cb.conv3x3_plain(_t(x), _t(k)[:, :, :8])


@pytest.mark.parametrize("case", ["square", "rectangular"])
def test_train_op_matches_reference(case):
    """conv3x3_bn_relu_train: the forward (out, batch mean, batch var)
    and the gradients of x, w, gamma and beta (jax.vjp against torch
    autograd) from one seeded cotangent."""
    x, k, *_ = _data(**{"b": 3, "h": 6, "w": 6, "cin": 8, "cout": 8,
                        **({"cout": 24} if case == "rectangular" else {})})
    cout = k.shape[3]
    gamma = np.linspace(0.6, 1.4, cout).astype(np.float32)
    beta = np.linspace(-0.2, 0.3, cout).astype(np.float32)
    ct = np.random.default_rng(1).normal(size=x.shape[:3] + (cout,)) \
        .astype(np.float32)
    (w_out, w_mean, w_var), vjp = jax.vjp(
        lambda *a: ref.conv3x3_bn_relu_train(*a, 1e-5, True), x, k, gamma,
        beta)
    want_grads = vjp((ct, jnp.zeros_like(w_mean), jnp.zeros_like(w_var)))
    args = [_t(a, True) for a in (x, k, gamma, beta)]
    out, mean, var = cb.conv3x3_bn_relu_train(*args, 1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(w_mean), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(w_var), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(w_out),
                               rtol=1e-3, atol=1e-3)
    out.backward(_t(ct))
    for a, w_, name in zip(args, want_grads, ("dx", "dw", "dgamma",
                                              "dbeta")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w_),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


def test_library_twins_match_reference_twins():
    x, k, scale, bias = _data(cin=8, cout=24)
    np.testing.assert_allclose(
        cb.torch_conv3x3_bn_relu(_t(x), _t(k), _t(scale), _t(bias)).numpy(),
        np.asarray(ref.xla_conv3x3_bn_relu(x, k, scale, bias)), rtol=1e-4,
        atol=1e-4)
    for a, b in zip(cb.torch_conv3x3_stats(_t(x), _t(k)),
                    ref.xla_conv3x3_stats(x, k)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("train", [True, False])
def test_pallas_conv_bn_module_matches_reference(train):
    """PallasConvBN3x3 from the reference's variables: output, updated
    running statistics and (train) parameter gradients."""
    # imported here: flax is needed by this test alone, and the tests
    # marked cuda run where only jax may be installed
    from horovod_tpu.models.resnet import PallasConvBN3x3 as RefPallasConvBN3x3

    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 6, 6, 8)).astype(np.float32)
    ct = rng.normal(size=(4, 6, 6, 16)).astype(np.float32)
    v = {"params": {"kernel": (rng.normal(size=(3, 3, 8, 16)) * 0.2)
                    .astype(np.float32),
                    "scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=16)).astype(np.float32)},
         "batch_stats": {"mean": (0.1 * rng.normal(size=16))
                         .astype(np.float32),
                         "var": rng.uniform(0.5, 2, 16).astype(np.float32)}}
    mod_ref = RefPallasConvBN3x3(features=16, train=train, dtype=jnp.float32)

    def f(p):
        return mod_ref.apply({"params": p, "batch_stats": v["batch_stats"]},
                             x, mutable=["batch_stats"])

    want, upd = f(v["params"])
    mod = PallasConvBN3x3(8, 16, dtype=torch.float32)
    with torch.no_grad():
        mod.weight.copy_(_t(v["params"]["kernel"]).permute(3, 2, 0, 1))
        mod.scale.copy_(_t(v["params"]["scale"]))
        mod.bias.copy_(_t(v["params"]["bias"]))
        mod.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        mod.running_var.copy_(_t(v["batch_stats"]["var"]))
    mod.train(train)
    got = mod(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-4, atol=1e-5)
    if train:
        _, vjp = jax.vjp(lambda p: f(p)[0], v["params"])
        (gp,) = vjp(ct)
        got.backward(_t(ct))
        for a, b, name in ((mod.weight.grad.permute(2, 3, 1, 0),
                            gp["kernel"], "dkernel"),
                           (mod.scale.grad, gp["scale"], "dscale"),
                           (mod.bias.grad, gp["bias"], "dbias")):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                       atol=2e-3, err_msg=name)


def test_wrappers_never_fall_back_for_card_tensors():
    """A tensor off the CPU goes to a kernel or raises (meta tensors stand
    in for card tensors): no plain version runs for them."""
    x = torch.empty(2, 4, 4, 8, device="meta")
    w = torch.empty(3, 3, 8, 8, device="meta")
    c = torch.empty(8, device="meta")
    before = dict(kernels.conv_bn_launches)
    for fn, args in ((cb.conv3x3_bn_relu, (x, w, c, c)),
                     (cb.conv3x3_stats, (x, w)), (cb.conv3x3_plain, (x, w))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
    assert kernels.conv_bn_launches == before


@pytest.mark.parametrize("x,w,error,match", [
    ((2, 4, 4, 8), (3, 3, 8, 8, torch.float16), TypeError, "one dtype"),
    ((2, 4, 4, 8), (3, 3, 4, 8), ValueError, "NHWC"),
    ((2, 4, 4, 8), (8, 8, 3, 3, "oihw"), ValueError, "contiguous"),
])
def test_kernel_checks_refuse_what_k8_k10_do_not_take(monkeypatch, x, w,
                                                     error, match):
    monkeypatch.setattr(kernels, "_check_on_card", lambda *a: None)
    xt = torch.empty(x, device="meta")
    if w[-1] == "oihw":      # an OIHW weight seen as HWIO: not contiguous
        wt = torch.empty(w[:4], device="meta").permute(2, 3, 1, 0)
    elif isinstance(w[-1], torch.dtype):
        wt = torch.empty(w[:4], dtype=w[-1], device="meta")
    else:
        wt = torch.empty(w, device="meta")
    with pytest.raises(error, match=match):
        kernels._check_conv(xt, wt)


#: an H100 SXM: its SMs, and the blocks of the wgmma mainloop one SM holds
#: (hvd_conv3x3_wgmma_occupancy on the card: 2 at either tile width)
H100 = (132, 2)

#: ResNet-50's stride-1 3x3 convs at batch 128: (x shape, Cout) and the
#: plan each takes on an H100 (mainloop, tile_n, row tiles of 128 pixels,
#: blocks: persistent at 56x56 only)
RESNET50_PLANS = {
    "56x56": (((128, 56, 56, 64), 64), ("wgmma", 64, 3136, 264)),
    "28x28": (((128, 28, 28, 128), 128), ("wgmma", 128, 784, 784)),
    "14x14": (((128, 14, 14, 256), 256), ("wgmma", 128, 196, 392)),
    "7x7": (((128, 7, 7, 512), 512), ("wgmma", 64, 49, 392)),
}


@pytest.mark.parametrize("shape", list(RESNET50_PLANS))
def test_resnet50_shapes_take_the_tma_wgmma_mainloop(shape):
    """Every ResNet-50 3x3 takes TMA + wgmma; tile_n 128 only where the
    128-wide grid keeps two tiles for each of the H100's 132 SMs; one
    block a tile unless there are four tiles for every block the card
    holds at once."""
    (x_shape, cout), (mainloop, tile_n, tiles, blocks) = \
        RESNET50_PLANS[shape]
    plan = kernels.conv3x3_plan(x_shape, cout, torch.bfloat16, 0, 4096,
                                *H100)
    assert plan == kernels.ConvPlan(mainloop, 128, tile_n, tiles, blocks)
    assert tiles * -(-cout // tile_n) >= 2 * H100[0] or tile_n == 64
    all_tiles = tiles * -(-cout // tile_n)
    slots = H100[0] * H100[1]
    assert blocks == (slots if all_tiles >= kernels.WGMMA_PERSIST_WAVES
                      * slots else all_tiles)


@pytest.mark.parametrize("card,want", [
    ((132, 2), (64, 264)), ((132, 1), (64, 132)), ((66, 2), (64, 132)),
    ((16, 2), (128, 32))], ids=["h100", "one_a_sm", "half_the_sms",
                                "sixteen_sms"])
def test_wgmma_schedule_follows_the_card(card, want):
    """tile_n and the block count come from the card the plan is given:
    at 56x56 (3136 tiles of 64 columns) every card here is persistent
    with as many blocks as it holds at once; a Cout of 128 takes the
    wider tile once two 128-wide tiles an SM remain."""
    tile_n, blocks = want
    cout = 64 if tile_n == 64 else 128
    plan = kernels.conv3x3_plan((128, 56, 56, cout), cout, torch.bfloat16,
                                0, 0, *card)
    assert (plan.tile_n, plan.blocks) == (tile_n, blocks)


@pytest.mark.parametrize("x_shape,cout,dtype,offset,want", [
    ((2, 5, 7, 3), 16, torch.bfloat16, 0, ("mma_sync", 64)),  # Cin 3
    ((2, 9, 7, 24), 24, torch.bfloat16, 0, ("wgmma", 64)),    # Cin 24
    ((2, 6, 10, 24), 40, torch.bfloat16, 0, ("wgmma", 64)),   # Cout 40
    ((2, 5, 7, 16), 12, torch.bfloat16, 0, ("mma_sync", 64)),  # Cout 12
    ((2, 16, 16, 64), 64, torch.float32, 0, ("f32", 64)),
], ids=["cin3", "cin24", "cout40", "cout12", "float32"])
def test_conv_dispatch_rule(x_shape, cout, dtype, offset, want):
    """Channel counts TMA cannot address (not a multiple of 8) take
    mma.sync; float32 the scalar kernel."""
    plan = kernels.conv3x3_plan(x_shape, cout, dtype, 4096 + offset, 8192,
                                *H100)
    assert (plan.mainloop, plan.tile_n) == want
    assert plan.tile_m == (64 if dtype == torch.float32 else 128)
    m = x_shape[0] * x_shape[1] * x_shape[2]
    assert plan.row_tiles == -(-m // plan.tile_m)


def test_dispatch_rule_reads_a_misaligned_view():
    """A one-element view of a CPU buffer is 2 bytes off: mma.sync."""
    buf = torch.zeros(2 * 5 * 7 * 16 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(2, 5, 7, 16)
    w = torch.zeros(3, 3, 16, 16, dtype=torch.bfloat16)
    assert x.data_ptr() % 16 and buf.data_ptr() % 16 == 0
    for t, want in ((x, "mma_sync"), (buf[:-1].view(2, 5, 7, 16), "wgmma")):
        plan = kernels.conv3x3_plan(tuple(t.shape), 16, t.dtype,
                                    t.data_ptr(), w.data_ptr(), *H100)
        assert plan.mainloop == want


@pytest.mark.parametrize("shape", list(RESNET50_PLANS))
def test_k9_scratch_follows_the_m_tile(shape):
    (x_shape, cout), (_, _, tiles, _) = RESNET50_PLANS[shape]
    plan = kernels.conv3x3_plan(x_shape, cout, torch.bfloat16, 0, 0, *H100)
    scratch = kernels.conv3x3_stats_scratch(plan, cout, torch.device("meta"))
    assert tuple(scratch.shape) == (2, tiles, cout)
    assert scratch.dtype == torch.float32


def test_launch_hands_the_plan_to_the_kernel(monkeypatch):
    """launch_conv3x3 passes the plan's mainloop, tile_n, row tiles and
    blocks in HvdConvArgs, from the card its tensors are on, and counts
    the launch under its kind and mainloop (meta tensors stand in for
    card tensors; nothing is launched)."""
    seen = []
    monkeypatch.setattr(kernels, "_check_on_card", lambda *a: None)
    monkeypatch.setattr(kernels, "wgmma_card", lambda index: H100)
    monkeypatch.setattr(kernels, "_launch",
                        lambda fn, counts, key, dev, args:
                        seen.append((counts is kernels.conv_bn_launches,
                                     key, args._obj)))
    x = torch.empty(128, 7, 7, 512, dtype=torch.bfloat16, device="meta")
    w = torch.empty(3, 3, 512, 512, dtype=torch.bfloat16, device="meta")
    kernels.launch_conv3x3("stats", x, w)
    kernels.launch_conv3x3("plain", x, w, mainloop="mma_sync")
    (ca, ka, a), (cb_, kb, b) = seen
    assert ca and cb_ and (ka, kb) == ("stats.wgmma", "plain.mma_sync")
    assert (a.mainloop, a.tile_n, a.tiles, a.blocks, a.epilogue) == \
        (1, 64, 49, 392, 1)
    assert (b.mainloop, b.tile_n, b.tiles, b.blocks, b.epilogue) == \
        (0, 64, 49, 0, 0)
    with pytest.raises(ValueError, match="mma_sync"):
        kernels.launch_conv3x3("plain", x.float(), w.float(),
                               mainloop="mma_sync")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 14, 14, 64, 64), (2, 9, 7, 24, 40), (2, 56, 56, 64, 64),
    (2, 28, 28, 128, 128), (2, 14, 14, 256, 256), (2, 7, 7, 512, 512)])
def test_kernels_match_plain_versions_on_card(shape, dtype):
    """K8, K9 and K10 on the card against their plain versions, at the
    tolerances of chip_smoke.py's conv_kernels phase, at a small case,
    a ragged one and ResNet-50's four channel counts at batch 2; bf16 on
    the mainloop the plan names (TMA + wgmma for all of these)."""
    if not torch.cuda.is_available():
        pytest.skip("K8-K10 are CUDA C++ and run only on an NVIDIA card "
                    "(python3 chip_smoke.py runs them there)")
    import chip_smoke

    b, h, w, cin, cout = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, h, w, cin, device="cuda", generator=gen).to(dt)
    k = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
         * (9 * cin) ** -0.5).to(dt)
    s = torch.rand(cout, device="cuda", generator=gen) + 0.5
    c = torch.randn(cout, device="cuda", generator=gen)
    before = dict(kernels.conv_bn_launches)
    chip_smoke._conv_case(cb, x, k, s, c)   # fails the test on a mismatch
    loop = "wgmma" if dt == torch.bfloat16 else "f32"
    assert {n: v - before[n] for n, v in kernels.conv_bn_launches.items()
            if v != before[n]} == \
        {f"{e}.{loop}": 1 for e in ("bn_relu", "stats", "plain")}
