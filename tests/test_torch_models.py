"""horovod_tpu_torch's image registry beyond the ResNets (VGG, Inception
V3, ViT) against horovod_tpu.models, from weights converted by
horovod_tpu_torch.convert: the registry itself, names, order and sizes
of every leaf at full size, the flax -> torch -> flax round trip, and
whole models on seeded inputs — logits, train-mode BatchNorm statistics
and every parameter's gradient.

The whole models are compared in float64 (the reference inside
``jax.enable_x64``), where summation order cannot hide an algorithmic
difference.  Every model casts its logits to float32, and ViT computes
its head in float32 (as the reference does), so:

* logits agree to one float32 rounding (rtol 1e-6 of the largest);
* statistics to float64 summation-order error (rtol 1e-9);
* gradients, each leaf relative to its largest entry, to 1e-9 for VGG,
  whose backward runs in float64 after the cast; 1e-7 for Inception V3,
  whose last stage at 75x75 is 1x1, so its BatchNorms normalize over 2
  values and amplify summation-order error (measured: 3.8e-9); and 1e-5
  for ViT, whose float32 head rounds the gradient that flows into the
  encoder.  A leaf whose exact gradient is 0 carries only rounding
  noise, so it is held to the same tolerance relative to the largest
  gradient of the model instead: a conv bias that a BatchNorm follows
  (the normalization removes it), and the attention's key bias (adding
  q·b to every score of a row leaves the softmax unchanged).

The whole Inception V3 takes about 17 s here, so it is marked slow; its
stem convs and each of the blocks A-E are compared on their own at
small sizes in float64 (outputs, statistics and gradients to 1e-9), and
the whole model's names, shapes and order at 299x299 are checked too.

ViT is also compared through the ``attention_fn`` slot with flash
attention on both sides (the reference's Pallas kernels in interpret
mode, the port's plain versions of K2-K4) at a ragged length of 17
tokens, in float32: logits and gradients to 2e-4 of the largest, the
flash tests' own tolerance.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.models as ref_models
from horovod_tpu.models import inception as ref_inception
from horovod_tpu.models.inception import InceptionV3 as RefInceptionV3
from horovod_tpu.models.vgg import VGG11 as RefVGG11
from horovod_tpu.models.vgg import VGG16 as RefVGG16
from horovod_tpu.models.vit import ViT as RefViT
from horovod_tpu.ops.flash_attention import flash_attention as ref_flash
from horovod_tpu_torch import models
from horovod_tpu_torch.convert import (
    canonical_batch_stats, canonical_layouts, canonical_params,
    export_flax_variables, flatten_flax, load_flax_variables,
)
from horovod_tpu_torch.models import VGG11, VGG16, InceptionV3, ViT
from horovod_tpu_torch.models import inception
from horovod_tpu_torch.ops.flash_attention import flash_attention

#: a 2-layer ViT at 32x32 with patch 8: 16 patches and the class token
TINY_VIT = dict(patch_size=8, hidden_dim=32, num_layers=2, num_heads=4,
                mlp_dim=64)

#: name: (reference model, port model, image size)
CASES = {
    # 64x64: the last pool leaves 2x2, so the first Dense's rows see the
    # reference's (h, w, c) flatten order
    "VGG11_bn": (functools.partial(RefVGG11, batch_norm=True),
                 functools.partial(VGG11, batch_norm=True), 64),
    "VGG16": (RefVGG16, VGG16, 32),
    "InceptionV3": (RefInceptionV3, InceptionV3, 75),
    "ViT": (functools.partial(RefViT, **TINY_VIT),
            functools.partial(ViT, **TINY_VIT), 32),
}
GRAD_TOL = {"VGG11_bn": 1e-9, "VGG16": 1e-9, "InceptionV3": 1e-7,
            "ViT": 1e-5}
#: leaves whose exact gradient is 0 (see the module docstring)
ZERO_GRAD = {"VGG11_bn": re.compile(r"Conv_\d+/bias$"),
             "ViT": re.compile(r"key/bias$")}
BATCH = 2
CLASSES = 10


@pytest.fixture(autouse=True)
def _on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _drawn(shapes, seed):
    """Variables of the reference's shapes drawn from a seed (cheaper
    than running the reference's init, and every leaf nonzero, so zero
    biases, unit scales and fresh statistics hide no swapped or misnamed
    leaf): kernels of variance 1/fan_in, scales and variances in [0.5,
    1.5], the rest small."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape, key = leaf.shape, path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.normal(size=shape) / np.sqrt(fan_in)
        elif key in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = 0.1 * rng.normal(size=shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Seeded images, drawn reference variables (float32 numpy) and the
    loss's seeded weights on the logits."""
    ref_cls, _, size = CASES[name]
    rng = np.random.default_rng(17)
    x = rng.uniform(size=(BATCH, size, size, 3)).astype(np.float32)
    ref = ref_cls(num_classes=CLASSES, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), x))
    w = rng.normal(size=(BATCH, CLASSES))
    return x, _drawn(shapes, 5), w


@functools.lru_cache(maxsize=None)
def _reference(name, attn=None, float64=True):
    """The reference's logits, updated statistics and the gradient of
    ``sum(logits * w)``, all as numpy (flax paths)."""
    ref_cls, _, _ = CASES[name]
    x, variables, w = _case(name)
    dt = np.float64 if float64 else np.float32
    kw = {"attention_fn": (lambda q, k, v, m: ref_flash(q, k, v))} \
        if attn == "flash" else {}
    with jax.enable_x64(float64):
        ref = ref_cls(num_classes=CLASSES, dtype=dt, param_dtype=dt, **kw)
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), variables)
        stats = v.get("batch_stats")

        def loss(params):
            vs = {"params": params}
            if stats is not None:
                logits, upd = ref.apply({**vs, "batch_stats": stats},
                                        x.astype(dt), train=True,
                                        mutable=["batch_stats"])
            else:
                logits, upd = ref.apply(vs, x.astype(dt)), {}
            return (logits.astype(dt) * w.astype(dt)).sum(), (
                logits, upd)

        (_, (logits, upd)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"])
        return (np.asarray(logits),
                {k: np.asarray(a, np.float64) for k, a in
                 flatten_flax(upd.get("batch_stats", {})).items()},
                flatten_flax(grads))


def _port(name, attn=None, float64=True):
    _, port_cls, size = CASES[name]
    x, variables, w = _case(name)
    dt = torch.float64 if float64 else torch.float32
    kw = {"attention_fn": (lambda q, k, v, m: flash_attention(q, k, v))} \
        if attn == "flash" else {}
    # ViT casts explicitly to its dtype; the conv nets leave float64 to
    # the parameters (their dtype only switches autocast)
    model_dt = dt if name == "ViT" else torch.float32
    model = port_cls(num_classes=CLASSES, dtype=model_dt, image_size=size,
                     **kw)
    load_flax_variables(model, variables["params"],
                        variables.get("batch_stats"))
    model.to(dt).train()
    params = canonical_params(model)
    logits = model(torch.from_numpy(x).to(dt))
    loss = (logits.to(dt) * torch.from_numpy(w).to(dt)).sum()
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return (logits.detach().numpy(),
            {k: t.double().numpy() for k, t in
             canonical_batch_stats(model).items()},
            export_flax_variables(grads, canonical_layouts(model)))


def _close_to_max(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _assert_grads_match(grads, r_grads, tol, zero=None):
    assert list(grads) == list(r_grads)
    largest = max(np.abs(g).max() for g in r_grads.values())
    for k in r_grads:
        if zero is not None and zero.search(k):
            for g in (grads[k], r_grads[k]):
                assert np.abs(g).max() <= tol * largest, k
            continue
        assert np.abs(r_grads[k]).max() > 0, k
        _close_to_max(grads[k], r_grads[k], tol, k)


def _assert_match(got, want, grad_tol, zero=None, logit_tol=1e-6,
                  stat_tol=1e-9):
    (logits, stats, grads), (r_logits, r_stats, r_grads) = got, want
    assert logits.dtype == np.float32 and logits.shape == (BATCH, CLASSES)
    _close_to_max(logits, r_logits, logit_tol, "logits")
    assert list(stats) == list(r_stats)
    for k in r_stats:
        _close_to_max(stats[k], r_stats[k], stat_tol, k)
    _assert_grads_match(grads, r_grads, grad_tol, zero)


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n == "InceptionV3" else n
    for n in CASES])
def test_logits_statistics_and_gradients_match_float64(name):
    _assert_match(_port(name), _reference(name), GRAD_TOL[name],
                  ZERO_GRAD.get(name))


def test_vit_flash_attention_slot_matches_at_a_ragged_length():
    want = _reference("ViT", attn="flash", float64=False)
    got = _port("ViT", attn="flash", float64=False)
    _assert_match(got, want, 2e-4, ZERO_GRAD["ViT"], logit_tol=2e-4)


#: Inception blocks on their own: (block, its kwargs); inputs of 16
#: channels at 9x9 (B and D reduce it to 4x4 with their VALID stride-2
#: convs)
BLOCKS = {"A": ("InceptionA", {"pool_features": 8}),
          "B": ("InceptionB", {}),
          "C": ("InceptionC", {"c7": 8}),
          "D": ("InceptionD", {}),
          "E": ("InceptionE", {})}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_inception_block_matches_float64(block):
    """One block: its output (NHWC), statistics and gradients, float64
    on both sides, to 1e-9 of each array's largest entry."""
    cls_name, kw = BLOCKS[block]
    rng = np.random.default_rng(23)
    x = rng.uniform(size=(BATCH, 9, 9, 16))
    with jax.enable_x64(True):
        conv = functools.partial(ref_inception.ConvBN, dtype=jnp.float64,
                                 param_dtype=jnp.float64, train=True)

        def c(features, kernel, **ckw):
            return conv(features=features, kernel=kernel, **ckw)

        ref = getattr(ref_inception, cls_name)(conv=c, **kw)
        shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), x))
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), _drawn(shapes, 6))
        out_shape = jax.eval_shape(lambda: ref.apply(
            variables, x, mutable=["batch_stats"])[0]).shape
        w = rng.normal(size=out_shape)

        def loss(params):
            out, upd = ref.apply({"params": params,
                                  "batch_stats": variables["batch_stats"]},
                                 x, mutable=["batch_stats"])
            return (out * w).sum(), (out, upd)

        (_, (want, upd)), r_grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"])
        r_stats = flatten_flax(upd["batch_stats"])
        r_grads = flatten_flax(r_grads)
    model = getattr(inception, cls_name)(16, **kw)
    load_flax_variables(model, variables["params"],
                        variables["batch_stats"])
    model.double().train()
    params = canonical_params(model)
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    grads = dict(zip(params, torch.autograd.grad(
        (out * torch.from_numpy(w)).sum(), list(params.values()))))
    _close_to_max(out.detach().numpy(), np.asarray(want), 1e-9, "output")
    stats = canonical_batch_stats(model)
    assert list(stats) == list(r_stats)
    for k, t in stats.items():
        _close_to_max(t.numpy(), np.asarray(r_stats[k]), 1e-9, k)
    _assert_grads_match(export_flax_variables(grads,
                                              canonical_layouts(model)),
                        r_grads, 1e-9)


@pytest.mark.parametrize("name", list(CASES))
def test_flax_torch_flax_round_trip_is_exact(name):
    _, port_cls, size = CASES[name]
    _, variables, _ = _case(name)
    model = port_cls(num_classes=CLASSES, dtype=torch.float32,
                     image_size=size)
    load_flax_variables(model, variables["params"],
                        variables.get("batch_stats"))
    got = export_flax_variables(canonical_params(model),
                                canonical_layouts(model))
    want = flatten_flax(variables["params"])
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    stats = flatten_flax(variables.get("batch_stats", {}))
    assert list(canonical_batch_stats(model)) == list(stats)
    for k, t in canonical_batch_stats(model).items():
        np.testing.assert_array_equal(t.numpy(), stats[k], err_msg=k)


def test_registry_is_the_references():
    assert list(models.MODELS) == list(ref_models.MODELS)
    assert models.BATCH_STATS_FREE == ref_models.BATCH_STATS_FREE


#: full-size registry models: (name, image size, parameters)
FULL = [("VGG16", 224, 138_357_544), ("InceptionV3", 299, 23_834_568),
        ("ViT-B16", 224, 86_567_656)]


@pytest.mark.parametrize("name,size,count", FULL)
def test_canonical_names_shapes_and_order_match_at_full_size(name, size,
                                                             count):
    ref = ref_models.MODELS[name](num_classes=1000)
    shapes = jax.eval_shape(lambda: ref.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    with torch.device("meta"):
        model = models.MODELS[name](num_classes=1000, image_size=size)
    layouts = canonical_layouts(model)
    for collection, ours in (("params", canonical_params(model)),
                             ("batch_stats", canonical_batch_stats(model))):
        theirs = jax.tree_util.tree_flatten_with_path(
            shapes.get(collection, {}))[0]
        assert list(ours) == ["/".join(k.key for k in p) for p, _ in theirs]
        if collection == "params":
            assert [layouts[k].flax_shape for k in ours] == \
                [tuple(a.shape) for _, a in theirs]
    assert sum(t.numel() for t in canonical_params(model).values()) == count


@pytest.mark.parametrize("factory,kw,match", [
    (InceptionV3, {"image_size": 74}, "at least 75"),
    (ViT, {"image_size": 30, "patch_size": 8}, "not divisible"),
    (VGG16, {"image_size": 16}, "too small"),
])
def test_sizes_the_reference_cannot_take_raise(factory, kw, match):
    with pytest.raises(ValueError, match=match):
        factory(num_classes=10, **kw)


@pytest.fixture()
def bench_env(monkeypatch):
    from horovod_tpu_torch import core

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    yield
    core.shutdown()


@pytest.mark.parametrize("name,size,fused", [("VGG11", 32, False),
                                             ("ViT-S16", 32, True)])
def test_synthetic_benchmark_trains_the_registry_on_cpu(bench_env, name,
                                                        size, fused):
    """A BatchNorm-free ViT (no statistics in its state) and VGG, with the
    per-leaf optax-style SGD and with K1's plain version."""
    from horovod_tpu_torch.examples import synthetic_benchmark as sb

    argv = ["--model", name, "--image-size", str(size), "--batch-size",
            "2", "--num-classes", "10", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "1", "--num-iters", "1",
            "--device", "cpu"] + (["--fused-optimizer"] if fused else [])
    seen = {}
    out = sb.run(sb.parse_args(argv), then=lambda step, state, x, y:
                 seen.update(state=state))
    assert np.isfinite(out["final_loss"])
    assert out["step_calls"] == {"eager": 2, "capture": 0, "replay": 0}
    state = seen["state"]
    # neither keeps statistics: ViT has no BatchNorm (BATCH_STATS_FREE),
    # and the classic VGG none either
    assert state.model_state == {}
    assert type(state.opt_state).__name__ == (
        "FusedOptState" if fused else "tuple")


@pytest.mark.parametrize("option", ["--norm-act", "--residual-join",
                                    "--conv-bn"])
def test_resnet_options_raise_for_other_models(bench_env, option):
    from horovod_tpu_torch.examples import synthetic_benchmark as sb

    with pytest.raises(ValueError, match="ResNet option"):
        sb.run(sb.parse_args(["--model", "VGG11", option, "pallas",
                              "--device", "cpu"]))
