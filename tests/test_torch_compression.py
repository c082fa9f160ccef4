"""horovod_tpu_torch.ops.compression against horovod_tpu.ops.compression.

Single process, on the CPU.  The quantizers' ``q`` must be bit-equal to
the reference compressors' and to ``numpy_quantize`` for every wire
dtype and group size 1, 4, 64 and 225 (int8 ships uncompressed from 64
ranks, e4m3 at 225: fewer than 2 levels), with the factor and the
decompressed values equal; integer and bool tensors pass through
untouched and a bf16 tensor is quantized as the reference quantizes it.
``lookup`` / ``register`` / ``from_env`` resolve as the reference's, the
guard trips on the same sequences, and ``residual_norm`` agrees to
float32 rounding (1e-6 relative).

Error feedback: the harness plays 4 ranks, each compressing its ``g +
r`` with the global max (the max over the ranks, as the MAX all-reduce
gives it), and sums the ranks' ``q`` itself; the mean and each rank's
new residual are held against ``numpy_error_feedback_reduce`` at 1e-5
(the reference's tolerance), for every wire dtype.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.ops import compression as ref
from horovod_tpu_torch.ops import compression as port

WIRES = {"int8": (ref.Int8Compressor, port.Int8Compressor),
         "fp8_e4m3": (ref.FP8Compressor, port.FP8Compressor),
         "fp8_e5m2": (ref.FP8E5M2Compressor, port.FP8E5M2Compressor)}


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


@pytest.mark.parametrize("group", [1, 4, 64, 225])
@pytest.mark.parametrize("wire", list(WIRES))
def test_quantizer_is_bit_equal_to_reference(wire, group):
    rc, pc = WIRES[wire]
    rng = np.random.default_rng(group)
    x = (rng.normal(size=(513,)) * rng.uniform(1e-3, 1e3)).astype(np.float32)
    rq, rctx = rc.compress_for(jnp.asarray(x), group)
    pq, pctx = pc.compress_for(torch.from_numpy(x), group)
    if rctx is None:                      # fewer than 2 levels: no wire cast
        assert pctx is None and not pc.keeps_levels(group)
        np.testing.assert_array_equal(pq.numpy(), x)
        return
    assert pq.dtype == pc.wire_dtype and pc.keeps_levels(group)
    np.testing.assert_array_equal(_torch_bits(pq), _bits(rq))
    nq, nfactor = ref.numpy_quantize(x, group, wire)
    np.testing.assert_array_equal(_torch_bits(pq), _bits(nq))
    assert pctx[0] == torch.float32
    assert float(pctx[1]) == float(rctx[1])
    assert float(pctx[1]) == pytest.approx(nfactor, rel=1e-6)
    np.testing.assert_array_equal(pc.decompress(pq, pctx).numpy(),
                                  np.asarray(rc.decompress(rq, rctx)))


@pytest.mark.parametrize("dtype", ["int32", "bool", "int16"])
@pytest.mark.parametrize("name", ["bf16", "int8", "fp8_e4m3", "fp8_e5m2"])
def test_non_float_tensors_pass_through(name, dtype):
    val = np.arange(5).astype(dtype)
    comp = port.Compression.lookup(name)
    c, ctx = comp.compress_for(torch.from_numpy(val), 8)
    assert ctx is None and c.numpy().dtype == val.dtype
    out = comp.decompress(c, ctx).numpy()
    np.testing.assert_array_equal(out, val)
    rc, rctx = ref.Compression.lookup(name).compress_for(jnp.asarray(val), 8)
    np.testing.assert_array_equal(np.asarray(rc), c.numpy())


@pytest.mark.parametrize("name", ["bf16", "int8", "fp8_e4m3", "fp8_e5m2"])
def test_bf16_tensor_is_compressed_as_the_reference(name):
    x = np.random.default_rng(3).normal(size=(64,)).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    rc, rctx = ref.Compression.lookup(name).compress_for(jnp.asarray(xb), 4)
    comp = port.Compression.lookup(name)
    pc, pctx = comp.compress_for(torch.from_numpy(x).to(torch.bfloat16), 4)
    np.testing.assert_array_equal(_torch_bits(pc), _bits(rc))
    out = comp.decompress(pc, pctx)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out.float().numpy(),
        np.asarray(ref.Compression.lookup(name).decompress(rc, rctx)).astype(
            np.float32))


def test_registry_names_and_lookup_match_reference():
    assert port.Compression.names() == ref.Compression.names()
    for name in ref.Compression.names() + [None, "", "ef_int8", "ef_fp8",
                                           "EF_BF16", " int8 "]:
        r, p = ref.Compression.lookup(name), port.Compression.lookup(name)
        assert type(r).__name__ == type(p).__name__
        assert r.name == p.name and r.wire_itemsize == p.wire_itemsize
        assert r.scale_exchange == p.scale_exchange
        for ef in (True, False):
            assert ref.Compression.lookup(name, error_feedback=ef).name == \
                port.Compression.lookup(name, error_feedback=ef).name
    assert port.Compression.lookup("fp16") is port.BF16Compressor
    with pytest.raises(ValueError, match="unknown compression"):
        port.Compression.lookup("zstd")


def test_register_adds_a_wire_format(monkeypatch):
    monkeypatch.setattr(port, "_REGISTRY", dict(port._REGISTRY))

    class Halve(port.NoneCompressor):
        name = "halve"

    port.Compression.register(" Halve ", Halve)
    assert port.Compression.lookup("halve") is Halve
    assert isinstance(port.Compression.lookup("ef_halve"), port.ErrorFeedback)


@pytest.mark.parametrize("env", [
    {}, {"HVD_COMPRESSION": "bf16"}, {"HVD_COMPRESSION": "fp16"},
    {"HVD_COMPRESSION": "int8"}, {"HVD_COMPRESSION": "fp8"},
    {"HVD_COMPRESSION": "fp8_e5m2"},
    {"HVD_COMPRESSION": "int8", "HVD_COMPRESSION_ERROR_FEEDBACK": "0"},
    {"HVD_COMPRESSION": "none", "HVD_COMPRESSION_ERROR_FEEDBACK": "1"},
])
def test_from_env_matches_reference(monkeypatch, env):
    for k in ("HVD_COMPRESSION", "HVD_COMPRESSION_ERROR_FEEDBACK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    r, p = ref.from_env(), port.from_env()
    assert r.name == p.name
    assert isinstance(p, port.ErrorFeedback) == isinstance(
        r, ref.ErrorFeedback)


@pytest.mark.parametrize("norms", [
    [1.0, 1.2, 0.9, 1.1, 5.0, 10.5, 11.0],
    [2.0, float("nan")],
    [0.0, 0.0, 0.0, 1e-29, 1e-28],
    [3.0, 3.0, 3.0, float("inf")],
])
@pytest.mark.parametrize("factor", [None, 2.0])
def test_guard_trips_on_the_same_sequence(monkeypatch, norms, factor):
    monkeypatch.delenv("HVD_COMPRESSION_GUARD_FACTOR", raising=False)
    r = ref.ErrorFeedbackGuard(factor=factor)
    p = port.ErrorFeedbackGuard(factor=factor)
    assert [r.observe(n) for n in norms] == [p.observe(n) for n in norms]
    assert r.baseline == p.baseline and r.factor == p.factor


def test_residual_norm_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(7, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)},
            "n": np.arange(3, dtype=np.int32)}
    want = ref.residual_norm(tree)
    got = port.residual_norm({"a": torch.from_numpy(tree["a"]),
                              "b": {"c": torch.from_numpy(tree["b"]["c"])},
                              "n": torch.from_numpy(tree["n"])})
    assert got == pytest.approx(want, rel=1e-6)
    assert port.residual_norm(()) == 0.0


def test_error_feedback_wrapper_and_init_state():
    ef = port.ErrorFeedback(port.Int8Compressor)
    assert ef.name == "ef_int8" and ef.wire_itemsize == 1
    assert ef.scale_exchange and port.ErrorFeedback().compressor is \
        port.Int8Compressor
    params = {"w": torch.ones(3, 2), "b": {"c": torch.ones(4)}}
    res = port.ErrorFeedback.init_state(params)
    assert res["w"].shape == (3, 2) and not res["b"]["c"].any()


@pytest.mark.parametrize("wire", list(WIRES))
def test_error_feedback_ranks_match_numpy_oracle(wire):
    """Four simulated ranks, 3 steps: each compresses ``g + r`` for 4
    summands with the global max; the harness sums the ranks' ``q``."""
    n, pc = 4, WIRES[wire][1]
    rng = np.random.default_rng(12)
    grads = [rng.normal(size=(33,)).astype(np.float32) for _ in range(n)]
    res_np = [np.zeros(33) for _ in range(n)]
    res = [torch.zeros(33) for _ in range(n)]
    for _ in range(3):
        mean_np, res_np = ref.numpy_error_feedback_reduce(grads, res_np,
                                                          wire=wire)
        xs = [torch.from_numpy(g) + r for g, r in zip(grads, res)]
        gmax = port.local_max_abs(xs).max()
        qs, ctxs = zip(*(pc.compress_for(x, n, max_abs=gmax) for x in xs))
        res = [x - pc.decompress(q, c) for x, q, c in zip(xs, qs, ctxs)]
        total = sum(q.float() for q in qs)
        mean = pc.decompress(port.average_(total, n), ctxs[0])
        np.testing.assert_allclose(mean.numpy(), mean_np, rtol=1e-5,
                                   atol=1e-5)
        for r, rn in zip(res, res_np):
            np.testing.assert_allclose(r.numpy(), rn, rtol=1e-5, atol=1e-5)
        res_np = [r.numpy().astype(np.float64) for r in res]


def test_float8_wire_is_refused_on_the_cpu_backend():
    with pytest.raises(RuntimeError, match="gloo cannot reduce"):
        port.check_wire(torch.float8_e4m3fn, torch.device("cpu"))
    port.check_wire(torch.int8, torch.device("cpu"))
    port.check_wire(torch.bfloat16, torch.device("cpu"))


def test_average_is_a_float_division_on_integer_and_fp8_wires():
    total = torch.tensor([7, -3, 5], dtype=torch.int8)
    out = port.average_(total, 2)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), [3.5, -1.5, 2.5])
    f8 = torch.tensor([3.0, 1.0]).to(torch.float8_e4m3fn)
    assert port.average_(f8, 2).dtype == torch.float32
    bf = torch.tensor([3.0, 1.0], dtype=torch.bfloat16)
    assert port.average_(bf, 2) is bf and bf.tolist() == [1.5, 0.5]


def test_uncompressed_fallback_is_counted():
    from horovod_tpu_torch import metrics

    before = metrics.COMPRESSION_FALLBACKS.get()
    port.Int8Compressor.compress_for(torch.ones(4), 100)
    port.FP8Compressor.compress_for(torch.ones(4), 100)
    assert metrics.COMPRESSION_FALLBACKS.get() == before + 1
