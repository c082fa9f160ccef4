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

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import elementwise as ref
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


def _edges(shape, seed):
    """Seeded normal values with the ones a masked gradient must treat as
    the reference does planted in turn: +0, -0, a negative and NaN (all
    masked: NaN > 0 is false), then a positive (passed)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[0::5] = 0.0
    flat[1::5] = -0.0
    flat[2::5] = -np.abs(flat[2::5])
    flat[3::5] = np.nan
    flat[4::5] = np.abs(flat[4::5])
    return x


def _bits(a) -> np.ndarray:
    """The raw bits of a float32 or bf16 array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        return a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _jt(a, dtype):
    """A float32 numpy array as (jax array, torch tensor) of dtype."""
    ja = jnp.asarray(a, getattr(jnp, dtype))
    return ja, torch.from_numpy(np.array(ja, np.float32)).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_grad_matches_reference_bit_for_bit(dtype):
    """K6' on its own: the port's relu-grad pass against the reference's
    _relu_grad_kernel (interpret mode) on outputs holding +0, -0,
    negatives and NaN and gradients holding -0: the same bits."""
    shape = (3, 5, 7, 36)
    out, jout_t = _jt(_edges(shape, 8), dtype)
    g_np = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    g_np.reshape(-1)[4::10] = -0.0
    g, g_t = _jt(g_np, dtype)
    want = ref._flat_call(ref._relu_grad_kernel, out, g, block_rows=1024,
                          interpret=None)
    got = ew._relu_grad(jout_t, g_t)
    assert got.dtype == g_t.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("join", ["residual_relu", "scale_bias_relu"])
def test_join_gradients_match_reference_bit_for_bit(join, dtype):
    """The backward of both joins through K6' against the reference's
    custom VJP (its _relu_grad_kernel in interpret mode), from inputs whose
    outputs hold +0, -0 and NaN and whose pre-activations hold negatives:
    dx (and dy) bit for bit; dscale and dbias, sums taken in other orders,
    at the JAX tests' 1e-5 (NaN where the reference has NaN)."""
    shape = (3, 5, 7, 36)
    x, tx = _jt(_edges(shape, 10), dtype)
    g, tg = _jt(np.random.default_rng(11).normal(size=shape)
                .astype(np.float32), dtype)
    tx.requires_grad_()
    if join == "residual_relu":
        y, ty = _jt(_edges(shape, 12), dtype)
        ty.requires_grad_()
        out, vjp = jax.vjp(ref_residual_relu, x, y)
        got = ew.residual_relu(tx, ty)
        got.backward(tg)
        pairs = ((tx.grad, vjp(g)[0]), (ty.grad, vjp(g)[1]))
        sums = ()
    else:
        c = shape[-1]
        s = np.random.default_rng(13).uniform(0.5, 1.5, c).astype(np.float32)
        b = np.random.default_rng(14).normal(size=c).astype(np.float32)
        b[::3] = 0.0  # x of +0 or -0 there makes an output of +0
        ts, tb = _t(s, True), _t(b, True)
        out, vjp = jax.vjp(ref_scale_bias_relu, x, s, b)
        got = ew.scale_bias_relu(tx, ts, tb)
        got.backward(tg)
        dx, ds, db = vjp(g)
        pairs = ((tx.grad, dx),)
        sums = ((ts.grad, ds), (tb.grad, db))
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(out, np.float32), rtol=2 ** -8,
                               atol=1e-6)
    assert np.isnan(np.asarray(out, np.float32)).any()
    for a, want in pairs:
        np.testing.assert_array_equal(_bits(a), _bits(want))
    for a, want in sums:
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_relu_grad_takes_only_its_own_loops():
    """K6' runs its own loop, or flat_binary's when asked (to be timed
    beside it); any other loop is refused before the wrapper's checks."""
    x = torch.empty(2, 8, device="meta")
    for loop in ("flat", "grid", "own", "stream", ("grid", 2, "none")):
        with pytest.raises(ValueError, match="has no loop"):
            kernels.launch_relu_grad(x, x, loop=loop)


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
                                 "residual_relu": 1,
                                 "scale_bias_relu_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [((2, 7, 7, 256), False),
                                          ((3, 5, 7, 36), False),
                                          ((2, 5, 7, 64), True)])
def test_relu_grad_loops_are_bit_equal_on_card(shape, offset, dtype):
    """K6' on its own loop and on flat_binary's against its plain version,
    bit for bit, on outputs holding +0, -0, negatives and NaN: aligned, a
    ragged element count and an operand off 16-byte alignment (the scalar
    loop)."""
    if not torch.cuda.is_available():
        pytest.skip("K6' is CUDA C++ and runs only on an NVIDIA card "
                    "(python3 chip_smoke.py runs it there)")
    dt = getattr(torch, dtype)
    out = torch.from_numpy(_edges(shape, 15)).to("cuda", dt)
    if offset:
        buf = torch.empty(out.numel() + 1, device="cuda", dtype=dt)
        out = buf[1:].view(shape).copy_(out)
    g = torch.randn(shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(16)).to(dt)
    want = ew.plain_relu_grad(out, g)
    for loop in (None, "flat_binary"):
        got = kernels.launch_relu_grad(out, g, loop=loop)
        torch.cuda.synchronize()
        assert np.array_equal(_bits(got.cpu()), _bits(want.cpu())), loop


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_bias_relu_bwd_matches_reference(dtype):
    """K6's backward: its plain version, and scale_bias_relu's backward
    through hvd::scale_bias_relu_bwd, against jax.vjp of the reference's
    scale_bias_relu (its Pallas kernels in interpret mode), from inputs
    whose outputs hold +0, -0 and NaN: dx bit for bit, dscale and dbias at
    the JAX tests' 1e-5 (NaN where the reference has NaN)."""
    shape = (3, 5, 7, 36)
    c = shape[-1]
    x, tx = _jt(_edges(shape, 20), dtype)
    g, tg = _jt(np.random.default_rng(21).normal(size=shape)
                .astype(np.float32), dtype)
    s = np.random.default_rng(22).uniform(0.5, 1.5, c).astype(np.float32)
    b = np.random.default_rng(23).normal(size=c).astype(np.float32)
    b[::3] = 0.0
    _, vjp = jax.vjp(lambda xx, ss, bb: ref_scale_bias_relu(
        xx, ss, bb, 1024, True), x, s, b)
    want = vjp(g)
    out = ew._scale_bias_relu(tx, _t(s), _t(b))
    plain = ew.plain_scale_bias_relu_bwd(tx, _t(s), out, tg)
    tx.requires_grad_()
    ts, tb = _t(s, True), _t(b, True)
    ew.scale_bias_relu(tx, ts, tb).backward(tg)
    for got in (plain, (tx.grad, ts.grad, tb.grad)):
        assert got[0].dtype == tx.dtype
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        for a, w in zip(got[1:], want[1:]):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)


def test_scale_bias_relu_bwd_op_under_make_fx_and_flop_counter():
    """hvd::scale_bias_relu_bwd is what make_fx records of K6's backward
    and what FlopCounterMode counts (5 FLOPs an element); the traced graph
    gives eager's results."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils.flop_counter import FlopCounterMode

    x, _, s, b, g = (_t(a) for a in _inputs((2, 3, 5, 16), 24))
    out = ew.plain_scale_bias_relu(x, s, b)
    args = (x, s, out, g)
    graph = make_fx(ew._scale_bias_relu_bwd)(*args)
    targets = [str(n.target) for n in graph.graph.nodes
               if n.op == "call_function"]
    assert targets == ["hvd.scale_bias_relu_bwd.default",
                       "<built-in function getitem>"] + \
        ["<built-in function getitem>"] * 2
    for a, w in zip(graph(*args), ew.plain_scale_bias_relu_bwd(*args)):
        assert torch.equal(a, w)
    with FlopCounterMode(display=False) as counter:
        ew._scale_bias_relu_bwd(*args)
    assert counter.get_total_flops() == 5 * x.numel()
    assert ew.EW_FLOPS_PER_ELEMENT["scale_bias_relu_bwd"] == 5


#: ResNet-50's BatchNormReLU joins (spatial size, C) and a card's SMs
RESNET_K6 = [(112, 64), (56, 64), (56, 128), (28, 128), (28, 256),
             (14, 256), (14, 512), (7, 512)]
SMS = 132


def _plan(kind, t, ptrs=(0,), loop=None):
    """kernels.elementwise_plan for a meta tensor ``t``."""
    return kernels.elementwise_plan(kind, t.dtype, tuple(t.shape), ptrs,
                                    SMS, loop)


@pytest.mark.parametrize("batch", [128, 32, 1])
@pytest.mark.parametrize("s,c", RESNET_K6)
def test_elementwise_plan_takes_resnet_joins_onto_the_channel_loop(batch, s,
                                                                   c):
    """Every ResNet-50 K6 shape, training and serving, runs K6 and its
    backward on the channel loop and K7 on the stream loop; the backward's
    blocks follow from the shape and the SMs alone."""
    x = torch.empty(batch, s, s, c, dtype=torch.bfloat16, device="meta")
    assert _plan("scale_bias_relu", x) == kernels.ElementwisePlan(
        "channel", 0)
    assert _plan("residual_relu", x) == kernels.ElementwisePlan("stream", 0)
    rounds = -(-x.numel() // 8 // (kernels.EW_BWD_THREADS *
                                   kernels.EW_BWD_PACKS))
    assert _plan("scale_bias_relu_bwd", x) == kernels.ElementwisePlan(
        "channel", min(SMS * kernels.EW_BWD_BLOCKS_PER_SM, rounds))


@pytest.mark.parametrize("cu_name,py_name", [
    ("kJoinThreads", "EW_THREADS"), ("kJoinPacks", "EW_PACKS"),
    ("kBwdThreads", "EW_BWD_THREADS"), ("kBwdPacks", "EW_BWD_PACKS"),
    ("kBwdGeneralThreads", "EW_BWD_GENERAL_THREADS"),
])
def test_elementwise_plan_mirrors_the_librarys_blocks(cu_name, py_name):
    """The plan sizes the backward's scratch and picks K6's loop from the
    blocks csrc/elementwise.cu launches; the two must name one block."""
    src = (kernels.CSRC / "elementwise.cu").read_text()
    found = re.findall(rf"\b{cu_name} = (\d+)[,;]", src)
    assert len(found) == 1, (cu_name, found)
    assert int(found[0]) == getattr(kernels, py_name)


@pytest.mark.parametrize("dtype,shape,ptrs,fwd,bwd", [
    # C = 36 and 30: no whole number of rows of packs a block
    (torch.bfloat16, (3, 5, 7, 36), (0,), "flat_binary", "general"),
    (torch.float32, (3, 5, 7, 36), (0,), "flat_binary", "general"),
    (torch.float32, (3, 5, 7, 32), (0,), "channel", "channel"),
    (torch.float32, (3, 5, 7, 30), (0,), "flat_binary", "general"),
    # one operand off 16-byte alignment
    (torch.bfloat16, (2, 5, 7, 64), (0, 2), "flat_binary", "general"),
    (torch.float32, (2, 5, 7, 64), (4, 0), "flat_binary", "general"),
    # a row wider than K6's block, then than the backward's
    (torch.bfloat16, (2, 7, 7, 2048), (0,), "flat_binary", "channel"),
    (torch.bfloat16, (2, 7, 7, 4096), (0,), "flat_binary", "general"),
    (torch.float32, (2, 7, 7, 1024), (0,), "flat_binary", "channel"),
    (torch.float32, (2, 7, 7, 512), (0,), "channel", "channel"),
])
def test_elementwise_plan_routes_by_channels_dtype_and_alignment(
        dtype, shape, ptrs, fwd, bwd):
    x = torch.empty(shape, dtype=dtype, device="meta")
    assert _plan("scale_bias_relu", x, ptrs).loop == fwd
    plan = _plan("scale_bias_relu_bwd", x, ptrs)
    assert plan.loop == bwd and 1 <= plan.blocks <= \
        SMS * kernels.EW_BWD_BLOCKS_PER_SM
    # K7 keeps the stream loop; a misaligned operand takes its scalar path
    assert _plan("residual_relu", x, ptrs).loop == "stream"


def test_elementwise_plan_sizes_the_backwards_blocks():
    """The backward's blocks: one a round of packs up to 2 an SM on the
    channel loop; one a EW_BWD_GENERAL_ROWS rows, at least 1, on the
    general route."""
    small = torch.empty(1, 7, 7, 512, dtype=torch.bfloat16, device="meta")
    big = torch.empty(128, 112, 112, 64, dtype=torch.bfloat16,
                      device="meta")
    odd = torch.empty(1000, 36, dtype=torch.bfloat16, device="meta")
    assert _plan("scale_bias_relu_bwd", small).blocks == 4  # 3136 packs
    assert _plan("scale_bias_relu_bwd", big).blocks == 2 * SMS
    assert _plan("scale_bias_relu_bwd", odd).blocks == 1000 // 64
    assert _plan("scale_bias_relu_bwd", odd[:10]).blocks == 1


def test_elementwise_plan_takes_only_its_own_loops():
    x = torch.empty(2, 8, 8, 64, dtype=torch.bfloat16, device="meta")
    for kind in ("scale_bias_relu", "residual_relu"):
        assert _plan(kind, x, loop="flat_binary") == \
            kernels.ElementwisePlan("flat_binary", 0)
    for kind, loop in (("scale_bias_relu_bwd", "flat_binary"),
                       ("scale_bias_relu", "stream"),
                       ("residual_relu", "channel")):
        with pytest.raises(ValueError, match="has no loop"):
            _plan(kind, x, loop=loop)
    with pytest.raises(ValueError, match="unknown elementwise kernel"):
        _plan("relu_grad", x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _plan("residual_relu", x.half())


def test_k6_backward_wrapper_never_falls_back_for_card_tensors():
    """K6's backward on tensors off the CPU goes to its kernel or raises:
    meta tensors (stand-ins for card tensors) raise before any build."""
    x = torch.empty(2, 3, 3, 8, device="meta")
    c = torch.empty(8, device="meta")
    before = dict(kernels.elementwise_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ew._scale_bias_relu_bwd(x, c, x, x)
    assert kernels.elementwise_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [((2, 7, 7, 256), False),
                                          ((3, 5, 7, 36), False),
                                          ((1001, 64), False),
                                          ((2, 5, 7, 64), True)])
def test_k6_k7_loops_and_k6_backward_on_card(shape, offset, dtype):
    """K6 and K7 on their plans' loops and on flat_binary, bit for bit
    against their plain versions, and K6's backward: dx bit for bit, the
    sums within 1e-5 of each channel's sum of |terms|, two calls
    bit-identical; aligned, a ragged row count, C = 36 and an operand off
    16-byte alignment."""
    if not torch.cuda.is_available():
        pytest.skip("K6, its backward and K7 are CUDA C++ and run only on "
                    "an NVIDIA card (python3 chip_smoke.py runs them there)")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(30)
    x, y, g = (torch.randn(shape, device="cuda", generator=gen).to(dt)
               for _ in range(3))
    if offset:
        buf = torch.empty(x.numel() + 1, device="cuda", dtype=dt)
        x = buf[1:].view(shape).copy_(x)
    c = shape[-1]
    s = torch.rand(c, device="cuda", generator=gen) + 0.5
    b = torch.randn(c, device="cuda", generator=gen)
    for loop in (None, "flat_binary"):
        assert torch.equal(kernels.launch_scale_bias_relu(x, s, b, loop=loop),
                           ew.plain_scale_bias_relu(x, s, b)), loop
        assert torch.equal(kernels.launch_residual_relu(x, y, loop=loop),
                           ew.plain_residual_relu(x, y)), loop
    out = ew.plain_scale_bias_relu(x, s, b)
    got = kernels.launch_scale_bias_relu_bwd(x, s, out, g)
    again = kernels.launch_scale_bias_relu_bwd(x, s, out, g)
    want = ew.plain_scale_bias_relu_bwd(x, s, out, g)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    gm = ew.plain_relu_grad(out, g).float().reshape(-1, c)
    for a, w, terms in zip(got[1:], want[1:],
                           (gm * x.float().reshape(-1, c), gm)):
        den = terms.abs().double().sum(0).clamp_min(1e-30)
        assert ((a.double() - w.double()).abs() / den).max() < 1e-5
    for a, w in zip(got, again):
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           w.view(torch.int16 if w.dtype == torch.bfloat16
                                  else torch.int32))
