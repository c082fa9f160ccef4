"""horovod_tpu_torch.models against horovod_tpu.models, from weights
converted by horovod_tpu_torch.convert: the layers where the two
frameworks differ by default (SAME padding of strided convs, flax's
BatchNorm statistics), then whole ResNet-18 / ResNet-50 (narrow, train
and eval mode) and the MLP.

Tolerances: the single layers and the MLP compute in float32 on both
sides; XLA's and PyTorch's convolutions and reductions sum in different
orders, so outputs agree to float32 accumulation error (~1e-6 relative
per layer), not bit for bit.  The whole ResNets are compared in float64,
where that error cannot hide an algorithmic difference, and in float32
as accuracy against the float64 result (see each test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from horovod_tpu.models.mlp import MLP as RefMLP
from horovod_tpu.models.resnet import ResNet18 as RefResNet18
from horovod_tpu.models.resnet import ResNet50 as RefResNet50
from horovod_tpu_torch.convert import (
    canonical_batch_stats, canonical_layouts, canonical_params,
    export_flax_variables, flatten_flax, load_flax_variables,
)
from horovod_tpu_torch.models import MLP, ResNet18, ResNet50
from horovod_tpu_torch.models.layers import BatchNorm, Conv

RTOL, ATOL = 1e-4, 1e-5


def _nhwc_to_torch(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (3, 1), (1, 2), (7, 2)])
def test_conv_same_padding_matches_flax(size, kernel, stride):
    """XLA pads SAME as (0, 1) for a stride-2 3x3 conv on an even input;
    Conv computes the same padding per call."""
    rng = np.random.default_rng(size * 10 + kernel)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    ref = fnn.Conv(4, (kernel, kernel), strides=(stride, stride),
                   use_bias=False)
    variables = ref.init(jax.random.PRNGKey(0), x)
    want = np.asarray(ref.apply(variables, x))
    conv = Conv(3, 4, kernel, stride)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(np.transpose(
            variables["params"]["kernel"], (3, 2, 0, 1)))))
        got = conv(_nhwc_to_torch(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_batchnorm_statistics_match_flax():
    """Normalization with the biased batch variance, and running averages
    ra = 0.9 ra + 0.1 batch with the BIASED variance."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 5, 5, 6)) * 3 + 1).astype(np.float32)
    ref = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    variables = ref.init(jax.random.PRNGKey(0), x)
    scale = rng.normal(size=6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    mean0 = rng.normal(size=6).astype(np.float32)
    var0 = rng.uniform(0.5, 2, size=6).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = ref.apply(variables, x, mutable=["batch_stats"])
    bn = BatchNorm(6)
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(a))
    got = bn(_nhwc_to_torch(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    # torch's own BatchNorm2d would blend in the unbiased variance
    n = x.size // 6
    unbiased = 0.9 * var0 + 0.1 * x.reshape(-1, 6).var(0) * n / (n - 1)
    assert not np.allclose(bn.running_var.numpy(), unbiased, rtol=1e-5)


def _randomized(variables, seed):
    """Reference variables with every leaf redrawn, so zero-initialized
    block scales and fresh statistics do not hide a path."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        a = np.asarray(leaf)
        if name == "kernel":
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, variables)


MODELS = {"ResNet18": (RefResNet18, ResNet18),
          "ResNet50": (RefResNet50, ResNet50)}


@functools.lru_cache(maxsize=None)
def _case(name):
    """Seeded input (2 images of 32x32) and randomized reference
    variables, as float32 numpy arrays."""
    x = np.random.default_rng(11).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    ref = MODELS[name][0](num_classes=10, num_filters=8, dtype=jnp.float32)
    return x, _randomized(ref.init(jax.random.PRNGKey(0), x), 5)


@functools.lru_cache(maxsize=None)
def _reference(name, train, float64):
    """The reference's logits and (updated) batch_stats; in float64
    inside ``jax.enable_x64``."""
    x, variables = _case(name)
    dt = np.float64 if float64 else np.float32
    with jax.enable_x64(float64):
        ref = MODELS[name][0](num_classes=10, num_filters=8, dtype=dt,
                              param_dtype=dt)
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), variables)
        if train:
            logits, upd = jax.jit(lambda v, a: ref.apply(
                v, a, train=True, mutable=["batch_stats"]))(v, x.astype(dt))
            stats = upd["batch_stats"]
        else:
            logits = jax.jit(lambda v, a: ref.apply(v, a, train=False))(
                v, x.astype(dt))
            stats = v["batch_stats"]
        return np.asarray(logits), {k: np.asarray(a, np.float64) for k, a
                                    in flatten_flax(stats).items()}


def _port(name, train, float64):
    x, variables = _case(name)
    model = MODELS[name][1](num_classes=10, num_filters=8,
                            dtype=torch.float32)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    if float64:
        model.double()
    model.train(train)
    with torch.no_grad():
        logits = model(torch.from_numpy(
            x.astype(np.float64 if float64 else np.float32))).numpy()
    return logits, {k: t.double().numpy() for k, t
                    in canonical_batch_stats(model).items()}


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("train", [True, False])
def test_resnet_logits_and_batch_stats_match(name, train):
    """The port computes the reference's function: both run in float64
    from the same converted weights.  Logits are cast to float32 by both
    models, so they agree to one float32 rounding (rtol 1e-6); the
    float64 statistics to float64 summation-order error, amplified by a
    BatchNorm over as few as 2 values in the last stage (rtol 1e-7)."""
    got, got_stats = _port(name, train, float64=True)
    want, want_stats = _reference(name, train, float64=True)
    assert got.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert list(got_stats) == list(want_stats)
    for k, a in got_stats.items():
        np.testing.assert_allclose(a, want_stats[k], rtol=1e-7, atol=1e-10,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_resnet_float32_as_accurate_as_reference(name):
    """In float32 at this size the last stage's BatchNorm normalizes over
    2 values, which amplifies rounding: the reference's own float32
    logits differ from its float64 logits by up to ~5e-2 (ResNet-50).
    So float32 parity is pinned as accuracy: the port's float32 logits
    and statistics are no further from the float64 result than twice the
    reference's float32 error (plus 1e-6 for a near-exact reference)."""
    exact, exact_stats = _reference(name, True, float64=True)

    def errors(run):
        logits, stats = run
        return (np.abs(logits.astype(np.float64) - exact).max(),
                max(np.abs(stats[k] - exact_stats[k]).max()
                    for k in exact_stats))

    port = errors(_port(name, True, float64=False))
    ref = errors(_reference(name, True, float64=False))
    for p, r in zip(port, ref):
        assert p <= 2 * r + 1e-6, (port, ref)


def test_canonical_names_and_shapes_match_reference():
    ref = RefResNet50(num_classes=1000)
    shapes = jax.eval_shape(lambda: ref.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    ref_params = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    ref_stats = jax.tree_util.tree_flatten_with_path(
        shapes["batch_stats"])[0]
    with torch.device("meta"):
        model = ResNet50(num_classes=1000)
    params, stats = canonical_params(model), canonical_batch_stats(model)
    assert list(params) == ["/".join(k.key for k in p) for p, _ in ref_params]
    assert list(stats) == ["/".join(k.key for k in p) for p, _ in ref_stats]
    assert sum(t.numel() for t in params.values()) == 25_557_032


def test_initialization_follows_flax():
    """Zero last-block scales, zero biases, unit norms, and kernels of
    lecun-normal spread (same distribution, not the same draws)."""
    model = ResNet50(num_classes=10, num_filters=8,
                     generator=torch.Generator().manual_seed(0))
    p = canonical_params(model)
    assert torch.count_nonzero(p["BottleneckBlock_0/BatchNorm_2/scale"]) == 0
    assert torch.all(p["BottleneckBlock_0/BatchNorm_0/scale"] == 1)
    assert torch.count_nonzero(p["Dense_0/bias"]) == 0
    k = p["BottleneckBlock_3/Conv_1/kernel"]          # fan_in 16 * 3 * 3
    assert abs(k.std().item() - (1 / 144) ** 0.5) < 0.02
    again = ResNet50(num_classes=10, num_filters=8,
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(k, canonical_params(again)[
        "BottleneckBlock_3/Conv_1/kernel"])


@pytest.mark.parametrize("option", [{"stem": "space_to_depth"},
                                    {"norm_act": "pallas"},
                                    {"residual_join": "pallas"},
                                    {"conv_bn": "pallas"}])
def test_later_slice_variants_raise(option):
    """Every option of the reference is ported: its kernel value
    constructs a model, and an unknown value raises."""
    model = ResNet18(num_classes=10, num_filters=8, **option)
    assert sum(t.numel() for t in canonical_params(model).values()) > 0
    with pytest.raises(ValueError, match="unknown"):
        ResNet18(num_classes=10, **{k: "bogus" for k in option})


ALL_VARIANTS = {"norm_act": "pallas", "residual_join": "pallas",
                "conv_bn": "pallas"}
OPTIONS = {"norm_act": {"norm_act": "pallas"},
           "residual_join": {"residual_join": "pallas"},
           "conv_bn": {"conv_bn": "pallas"},
           "space_to_depth": {"stem": "space_to_depth"},
           "all": ALL_VARIANTS}


@pytest.mark.parametrize("name,option", [("ResNet50", o) for o in OPTIONS]
                         + [("ResNet18", "all")])
def test_variant_names_and_shapes_match_reference(name, option):
    """The options rename a block's modules as flax's per-class counters
    do; the names, their order and every shape come from jax.eval_shape
    of the reference's init, and the parameter count is the plain
    model's."""
    ref = MODELS[name][0](num_classes=1000, **OPTIONS[option])
    shapes = jax.eval_shape(lambda: ref.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    with torch.device("meta"):
        model = MODELS[name][1](num_classes=1000, **OPTIONS[option])
    for got, tree in ((canonical_params(model), shapes["params"]),
                      (canonical_batch_stats(model), shapes["batch_stats"])):
        want = {"/".join(k.key for k in p): tuple(v.shape) for p, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert list(got) == list(want)
        layouts = canonical_layouts(model) if got is not None else None
        for k, t in got.items():
            flax_shape = layouts[k].flax_shape if k in layouts \
                else tuple(t.shape)
            assert flax_shape == want[k], k
    n = sum(t.numel() for t in canonical_params(model).values())
    assert n == {"ResNet50": 25_557_032, "ResNet18": 11_689_512}[name]


def _drawn_variables(ref, x, seed):
    """Seeded variables of the shapes ``ref.init`` makes (taken from
    jax.eval_shape, so no forward runs): kernels of lecun-normal spread,
    scales and variances in [0.5, 1.5), biases and means small."""
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _variant_case(name):
    """Seeded 4 images of 64x64 and drawn reference variables of the
    all-options model: at 64x64, batch 4, no BatchNorm normalizes fewer
    than 16 values."""
    x = np.random.default_rng(11).uniform(size=(4, 64, 64, 3)).astype(
        np.float32)
    ref = MODELS[name][0](num_classes=10, num_filters=8, dtype=jnp.float32,
                          **ALL_VARIANTS)
    return x, _drawn_variables(ref, x, 5)


#: (logits, statistics) tolerances of the all-options models in float32,
#: relative to the largest entry: the Pallas bodies accumulate in float32
#: even under jax.enable_x64, so this parity is float32 on both sides,
#: where a train-mode BatchNorm over 16 values amplifies summation-order
#: rounding.  Measured: ResNet-18 4.7e-6 / 2.7e-6, ResNet-50 8.5e-4 /
#: 1.0e-4 in train mode (the plain ResNet-50 reads 3.2e-4 at this size),
#: both below 5e-7 / exact in eval mode; the limits are 4-10x those.
VARIANT_TOL = {("ResNet18", True): (5e-5, 5e-5),
               ("ResNet50", True): (3e-3, 1e-3),
               ("ResNet18", False): (1e-5, 1e-7),
               ("ResNet50", False): (1e-5, 1e-7)}


@pytest.mark.parametrize("name,train", [
    ("ResNet18", True), ("ResNet18", False),
    pytest.param("ResNet50", True, marks=pytest.mark.slow),
    pytest.param("ResNet50", False, marks=pytest.mark.slow)])
def test_variant_logits_and_batch_stats_match(name, train):
    """The all-options models (K6, K7 and K8-K10's plain versions on the
    CPU) compute the reference's function: logits and updated batch
    statistics from the same converted weights, in float32."""
    x, variables = _variant_case(name)
    ref = MODELS[name][0](num_classes=10, num_filters=8, dtype=jnp.float32,
                          **ALL_VARIANTS)
    if train:
        want, upd = jax.jit(lambda v, a: ref.apply(
            v, a, train=True, mutable=["batch_stats"]))(variables, x)
        want_stats = flatten_flax(upd["batch_stats"])
    else:
        want = jax.jit(lambda v, a: ref.apply(v, a, train=False))(
            variables, x)
        want_stats = flatten_flax(variables["batch_stats"])
    model = MODELS[name][1](num_classes=10, num_filters=8,
                            dtype=torch.float32, **ALL_VARIANTS)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    got_stats = {k: t.numpy() for k, t in canonical_batch_stats(model).items()}
    tol, stats_tol = VARIANT_TOL[(name, train)]
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
    assert list(got_stats) == list(want_stats)
    for k, a in got_stats.items():
        w = np.asarray(want_stats[k])
        np.testing.assert_allclose(a, w, rtol=stats_tol,
                                   atol=stats_tol * np.abs(w).max(),
                                   err_msg=k)


def test_space_to_depth_stem_is_the_strided_conv():
    """The stem's 4x4 stride-1 conv over the space-to-depth input is the
    7x7 stride-2 conv padded 3 of the same kernel, in float64 to
    rounding."""
    from horovod_tpu_torch.models.resnet import SpaceToDepthConvInit

    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, 16, 12))).contiguous(memory_format=torch.channels_last)
    stem = SpaceToDepthConvInit(3, 8, generator=torch.Generator()
                                .manual_seed(0)).double()
    conv = Conv(3, 8, 7, 2, padding=((3, 3), (3, 3))).double()
    with torch.no_grad():
        conv.weight.copy_(stem.weight)
        torch.testing.assert_close(stem(x), conv(x), rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="even spatial dims"):
        stem(x[:, :, :15])


@pytest.mark.parametrize("train", [True, False])
def test_space_to_depth_logits_match_reference(train):
    """ResNet-18 with the space_to_depth stem from the reference's
    variables, float64 on both sides (the stem is plain convolution, no
    Pallas): logits to one float32 rounding, as the plain models."""
    x = np.random.default_rng(11).uniform(size=(2, 32, 32, 3))
    opt = {"stem": "space_to_depth"}
    ref = RefResNet18(num_classes=10, num_filters=8, dtype=jnp.float32,
                      **opt)
    variables = _drawn_variables(ref, x.astype(np.float32), 5)
    with jax.enable_x64(True):
        ref = RefResNet18(num_classes=10, num_filters=8, dtype=np.float64,
                          param_dtype=np.float64, **opt)
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables)
        want = jax.jit(lambda v, a: ref.apply(
            v, a, train=train, mutable=["batch_stats"])[0])(v, x)
        want = np.asarray(want)
    model = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32,
                     **opt)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    model.double().train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_variant_variables_round_trip(option):
    """load_flax_variables then export_flax_variables gives the
    reference's arrays back, for every option's layout rules."""
    x = np.zeros((1, 32, 32, 3), np.float32)
    ref = RefResNet18(num_classes=10, num_filters=8, **OPTIONS[option])
    variables = _drawn_variables(ref, x, 9)
    model = ResNet18(num_classes=10, num_filters=8, **OPTIONS[option])
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    got = export_flax_variables(canonical_params(model),
                                canonical_layouts(model))
    want = flatten_flax(variables["params"])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    stats = flatten_flax(variables["batch_stats"])
    for k, t in canonical_batch_stats(model).items():
        np.testing.assert_array_equal(t.numpy(), stats[k], err_msg=k)


def test_mlp_logits_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    ref = RefMLP(features=(16, 8, 4))
    variables = ref.init(jax.random.PRNGKey(1), x)
    model = MLP(8, (16, 8, 4))
    load_flax_variables(model, variables["params"])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply(variables, x)),
                               rtol=RTOL, atol=ATOL)
