"""horovod_tpu_torch.ops.fusion against horovod_tpu.ops.fusion.

FusionPlan is pure logic, so its bucket lists must equal the
reference's EXACTLY for the same leaves: ResNet-50's 161 parameters in
canonical order at several thresholds, mixed float32 / bfloat16 lists,
and explicit (and named) plans with their errors.  The reduced values are
checked on one rank and on 2 gloo processes against the numpy mean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.resnet import ResNet50 as RefResNet50
from horovod_tpu.ops import fusion as ref_fusion
from horovod_tpu_torch import core
from horovod_tpu_torch.convert import canonical_params, to_flax_layout
from horovod_tpu_torch.models import ResNet50
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.compression import Compression
from torch_dist_worker import fusion_inputs, launch

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(scope="module")
def resnet50_leaves():
    """(reference leaves, port meta leaves), both in canonical order."""
    m = RefResNet50(num_classes=1000)
    shapes = jax.eval_shape(
        lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    ref_names = ["/".join(k.key for k in p) for p, _ in flat]
    with torch.device("meta"):
        ours = canonical_params(ResNet50(num_classes=1000))
    assert list(ours) == ref_names
    for (_, ref), t in zip(flat, ours.values()):
        assert tuple(ref.shape) == to_flax_layout(
            np.empty(tuple(t.shape), np.uint8)).shape
    return [l for _, l in flat], list(ours.values())


@pytest.mark.parametrize("threshold", [64 << 20, 1 << 20, 1])
def test_resnet50_threshold_buckets_exact(resnet50_leaves, threshold):
    ref_leaves, ours = resnet50_leaves
    assert len(ours) == 161
    assert sum(t.numel() for t in ours) == 25_557_032
    ref = ref_fusion.FusionPlan(ref_leaves, threshold)
    got = fusion.FusionPlan(ours, threshold)
    assert got.buckets == ref.buckets
    assert got.bucket_compression == ref.bucket_compression


def _mixed_leaves(seed, n=40):
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(n):
        shape = tuple(int(s) for s in rng.integers(1, 9, rng.integers(0, 4)))
        specs.append((shape, str(rng.choice(["float32", "bfloat16"]))))
    ref = [np.zeros(s, _JAX[d]) for s, d in specs]
    ours = [torch.empty(s, dtype=_TORCH[d], device="meta") for s, d in specs]
    return ref, ours


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [1, 64, 1000, 1 << 20])
def test_mixed_dtype_threshold_buckets_exact(seed, threshold):
    ref, ours = _mixed_leaves(seed)
    assert fusion.FusionPlan(ours, threshold).buckets == \
        ref_fusion.FusionPlan(ref, threshold).buckets


def test_default_threshold_reads_env(monkeypatch):
    ref, ours = _mixed_leaves(3)
    monkeypatch.setenv("HVD_FUSION_THRESHOLD", "100")  # rounds up to 128
    got = fusion.FusionPlan(ours)
    assert got.threshold_bytes == 128
    assert got.buckets == ref_fusion.FusionPlan(ref).buckets


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_explicit_buckets_exact(seed):
    ref, ours = _mixed_leaves(seed, n=12)
    rng = np.random.default_rng(100 + seed)
    idx = [int(i) for i in rng.permutation(12)[:9]]   # 3 left unclaimed
    explicit = [idx[:2], idx[2:6], idx[6:]]
    comp = ["bf16", None, "none"]
    r = ref_fusion.FusionPlan(ref, explicit_buckets=explicit,
                              bucket_compression=comp)
    g = fusion.FusionPlan(ours, explicit_buckets=explicit,
                          bucket_compression=comp)
    assert g.buckets == r.buckets
    assert g.bucket_compression == r.bucket_compression
    assert sorted(i for b in g.buckets for i in b) == list(range(12))


@pytest.mark.parametrize("explicit,match", [
    ([[0, 1], [1]], "two buckets"),
    ([[0, 12]], "only 12 leaves"),
])
def test_explicit_plan_errors_match_reference(explicit, match):
    ref, ours = _mixed_leaves(5, n=12)
    with pytest.raises(ValueError, match=match):
        ref_fusion.FusionPlan(ref, explicit_buckets=explicit)
    with pytest.raises(ValueError, match=match):
        fusion.FusionPlan(ours, explicit_buckets=explicit)


def test_named_buckets_and_leaf_names_match_reference():
    rng = np.random.default_rng(7)
    tree = {"b": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                  "bias": rng.normal(size=(4,)).astype(np.float32)},
            "a": {"w": rng.normal(size=(5,)).astype(np.float32)},
            "Z": rng.normal(size=(2, 2)).astype(np.float32)}
    ttree = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(v))
             for k, v in tree.items()}
    names = ref_fusion.tree_leaf_names(tree)
    assert fusion.tree_leaf_names(ttree) == names
    named = [["kernel", "a/w"], ["nothing/here"], ["Z"]]
    leaves = jax.tree_util.tree_leaves(tree)
    r = ref_fusion.FusionPlan.from_named_buckets(leaves, names, named)
    g = fusion.FusionPlan.from_named_buckets(
        [torch.from_numpy(np.asarray(l)) for l in leaves], names, named)
    assert g.buckets == r.buckets


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def test_plan_that_misses_a_leaf_raises(port_cpu_world):
    ts = [torch.ones(3), torch.ones(2), torch.ones(4)]
    stale = fusion.FusionPlan(ts[:2])
    with pytest.raises(ValueError, match="covers 2 tensors but the call "
                                         "passed 3"):
        fusion.fused_allreduce(ts, plan=stale)


@pytest.mark.parametrize("threshold", [1, 100, 1 << 26])
def test_one_rank_values_and_input_untouched(port_cpu_world, threshold):
    arrays = fusion_inputs(0)
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    out = fusion.fused_allreduce(ts, threshold_bytes=threshold)
    for a, t, o in zip(arrays, ts, out):
        assert o.shape == t.shape and o.dtype == t.dtype
        np.testing.assert_array_equal(o.numpy(), a)   # Average over 1 rank
        np.testing.assert_array_equal(t.numpy(), a)   # input not modified
    out = fusion.fused_allreduce(ts, compression=Compression.bf16,
                                 threshold_bytes=threshold)
    for t, o in zip(ts, out):
        assert o.dtype == torch.float32
        assert torch.equal(o, t.to(torch.bfloat16).float())


def test_one_rank_pytree_keeps_structure(port_cpu_world):
    tree = {"b": {"k": torch.arange(6.0).reshape(2, 3)},
            "a": torch.ones(4), "c": [torch.zeros(2), torch.full((1,), 3.0)]}
    out = fusion.allreduce_pytree(tree, threshold_bytes=8)
    assert set(out) == {"a", "b", "c"} and isinstance(out["c"], list)
    assert torch.equal(out["b"]["k"], tree["b"]["k"])
    assert torch.equal(out["c"][1], tree["c"][1])


def test_two_gloo_ranks_against_numpy_mean(tmp_path):
    rcs, outs = launch("fusion", 2, tmp_path)
    assert rcs == [0, 0], "\n".join(outs)
    inputs = [fusion_inputs(r) for r in range(2)]
    mean = [np.mean([inputs[0][i], inputs[1][i]], axis=0)
            for i in range(len(inputs[0]))]
    for r in range(2):
        got = np.load(tmp_path / f"fusion.{r}.npz")
        for thr in (1, 1 << 10, 1 << 26):
            for i, m in enumerate(mean):
                # a sum of two float32 then one division: exact to 1 ulp
                np.testing.assert_allclose(got[f"Average_{thr}_{i}"], m,
                                           rtol=1e-6, atol=0)
                np.testing.assert_allclose(got[f"Sum_{thr}_{i}"], 2 * m,
                                           rtol=1e-6, atol=0)
        for i, m in enumerate(mean):
            np.testing.assert_allclose(got[f"tree_leaf{i}"], m, rtol=1e-6)
        assert float(got["loss"]) == 0.5
