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
    canonical_batch_stats, canonical_params, flatten_flax,
    load_flax_variables,
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
    with pytest.raises(NotImplementedError, match="later slice"):
        ResNet18(num_classes=10, num_filters=8, **option)
    with pytest.raises(ValueError, match="unknown"):
        ResNet18(num_classes=10, **{k: "bogus" for k in option})


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
