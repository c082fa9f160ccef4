"""horovod_tpu_torch.ops.elementwise against horovod_tpu.ops.elementwise
(the Pallas kernels as the JAX package's own tests run them off the TPU:
the default interpret resolution), and the port's ``BatchNormReLU``
against the reference's module.

Tolerances are the JAX tests' own (tests/test_elementwise.py): 1e-6 for
the residual join and the affine join's values, 1e-5 for the affine
join's gradients, and for ``BatchNormReLU`` 1e-5 on outputs, 1e-5/1e-4
on the running mean/var and 1e-4 relative / 1e-3 absolute on gradients
(both sides float32; the statistics are reductions summed in other
orders).  On the CPU the port runs the kernels' plain versions; the
kernels themselves are held to those bit for bit on the card (the test
marked ``cuda`` here, and ``python3 chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.elementwise import residual_relu as ref_residual_relu
from horovod_tpu.ops.elementwise import scale_bias_relu as ref_scale_bias_relu
from horovod_tpu_torch import kernels
from horovod_tpu_torch.models.resnet import BatchNormReLU
from horovod_tpu_torch.ops import elementwise as ew

#: the JAX tests' shape, and a ragged one: 105 rows of C = 36
SHAPES = [(2, 4, 4, 128), (3, 5, 7, 36)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("shape", SHAPES)
def test_residual_relu_matches_reference(shape):
    x, y, _, _, g = _inputs(shape, 1)
    want, vjp = jax.vjp(ref_residual_relu, x, y)
    tx, ty = _t(x, True), _t(y, True)
    got = ew.residual_relu(tx, ty)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    for a, b in zip((tx.grad, ty.grad), vjp(g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_scale_bias_relu_matches_reference(shape):
    x, _, s, b, g = _inputs(shape, 2)
    want, vjp = jax.vjp(ref_scale_bias_relu, x, s, b)
    tx, ts, tb = _t(x, True), _t(s, True), _t(b, True)
    got = ew.scale_bias_relu(tx, ts, tb)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    for a, c, name in zip((tx.grad, ts.grad, tb.grad), vjp(g),
                          ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_bf16_joins_round_like_the_reference():
    """In bf16 the residual join rounds the sum once to bf16 and the affine
    join computes in float32 and casts: within one bf16 rounding (2^-8
    relative) of the reference's bf16 results."""
    x, y, s, b, _ = _inputs((2, 3, 5, 64), 3)
    xb, yb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    tx, ty = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
              for a in (xb, yb))
    got = ew.residual_relu(tx, ty)
    want = ref_residual_relu(xb, yb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -8)
    got = ew.scale_bias_relu(tx, _t(s), _t(b))
    want = ref_scale_bias_relu(xb, s, b)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -8,
                               atol=1e-6)


def test_expanded_gradient_is_taken():
    """The gradient of a join that feeds ``mean`` arrives expanded (zero
    strides); both joins take it and agree with a dense copy of it."""
    x, y, s, b, _ = _inputs((2, 3, 3, 8), 4)
    g = np.random.default_rng(5).normal(size=(2, 1, 1, 8)).astype(np.float32)

    def grads(gt):
        tx, ty, ts = _t(x, True), _t(y, True), _t(s, True)
        ew.residual_relu(tx, ty).backward(gt)
        ew.scale_bias_relu(_t(x), ts, _t(b)).backward(gt)
        return tx.grad, ty.grad, ts.grad

    expanded = _t(g).expand(2, 3, 3, 8)
    assert expanded.stride()[1] == 0
    for a, c in zip(grads(expanded), grads(expanded.contiguous())):
        assert torch.equal(a, c)


def _module_variables(c, seed):
    rng = np.random.default_rng(seed)
    return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": (0.1 * rng.normal(size=c)).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(size=c).astype(np.float32),
                            "var": rng.uniform(0.5, 2, c).astype(np.float32)}}


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_relu_module_matches_reference(train):
    """Outputs, the updated running statistics, and the gradients of x,
    scale and bias (train mode: the full BatchNorm backward through the
    batch mean and variance)."""
    # imported here: flax is needed by this test alone, and the tests
    # marked cuda run where only jax may be installed
    from horovod_tpu.models.resnet import BatchNormReLU as RefBatchNormReLU

    rng = np.random.default_rng(6)
    x = (rng.normal(size=(8, 6, 6, 32)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=(8, 6, 6, 32)).astype(np.float32)
    v = _module_variables(32, 7)
    ref = RefBatchNormReLU(use_running_average=not train, dtype=jnp.float32)

    def f(xx, params):
        out, upd = ref.apply({"params": params,
                              "batch_stats": v["batch_stats"]}, xx,
                             mutable=["batch_stats"])
        return out, upd["batch_stats"]

    want, stats = f(x, v["params"])
    _, vjp = jax.vjp(lambda xx, p: f(xx, p)[0], x, v["params"])
    gx, gp = vjp(g)

    mod = BatchNormReLU(32, dtype=torch.float32)
    with torch.no_grad():
        for t, a in ((mod.weight, v["params"]["scale"]),
                     (mod.bias, v["params"]["bias"]),
                     (mod.running_mean, v["batch_stats"]["mean"]),
                     (mod.running_var, v["batch_stats"]["var"])):
            t.copy_(_t(a))
    mod.train(train)
    tx = _t(x, True)
    got = mod(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-4,
                               atol=1e-6)
    for a, b, name in ((tx.grad, gx, "dx"), (mod.weight.grad, gp["scale"],
                                              "dscale"),
                       (mod.bias.grad, gp["bias"], "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-3, err_msg=name)


def test_wrappers_never_fall_back_for_card_tensors():
    """A tensor off the CPU goes to a kernel or raises; here meta tensors
    stand in for card tensors, and the wrappers' checks raise before any
    build rather than quietly run the plain versions."""
    x = torch.empty(2, 3, 3, 8, device="meta")
    c = torch.empty(8, device="meta")
    before = dict(kernels.elementwise_launches)
    for fn, args in ((ew.residual_relu, (x, x)),
                     (ew.scale_bias_relu, (x, c, c)),
                     (ew._relu_grad, (x, x))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
    assert kernels.elementwise_launches == before


@pytest.mark.parametrize("args,error,match", [
    ((torch.empty(2, 8, dtype=torch.float16, device="meta"),),
     TypeError, "float32 or bfloat16"),
    ((torch.empty(2, 8, device="meta"),
      torch.empty(2, 8, dtype=torch.bfloat16, device="meta")),
     TypeError, "one dtype"),
    ((torch.empty(2, 8, device="meta"), torch.empty(8, 2, device="meta")),
     ValueError, "differ in shape"),
    ((torch.empty(8, 2, device="meta").t(),), ValueError, "contiguous"),
])
def test_kernel_checks_refuse_what_k6_k7_do_not_take(monkeypatch, args,
                                                    error, match):
    monkeypatch.setattr(kernels, "_check_on_card", lambda *a: None)
    with pytest.raises(error, match=match):
        kernels._check_elementwise(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 7, 7, 256), (3, 5, 7, 36)])
def test_kernels_are_bit_equal_to_plain_versions_on_card(shape, dtype):
    """K6, K6' and K7 on the card against their plain versions, bit for
    bit (chip_smoke.py's elementwise_kernels phase covers the ResNet-50
    shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("K6-K7 are CUDA C++ and run only on an NVIDIA card "
                    "(python3 chip_smoke.py runs them there)")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, y, g = (torch.randn(shape, device="cuda", generator=gen).to(dt)
               for _ in range(3))
    s, b = (torch.randn(shape[-1], device="cuda", generator=gen)
            for _ in range(2))
    before = dict(kernels.elementwise_launches)
    out = ew._residual_relu(x, y)
    assert torch.equal(out, ew.plain_residual_relu(x, y))
    assert torch.equal(ew._relu_grad(out, g), ew.plain_relu_grad(out, g))
    assert torch.equal(ew._scale_bias_relu(x, s, b),
                       ew.plain_scale_bias_relu(x, s, b))
    assert {k: kernels.elementwise_launches[k] - before[k]
            for k in before} == {"scale_bias_relu": 1, "relu_grad": 1,
                                 "residual_relu": 1}
