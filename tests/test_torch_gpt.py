"""horovod_tpu_torch's Transformer path (models/bert.py, models/gpt.py,
the layers under them, convert.py's rules for them, utils/flops.py and
the GPT benchmark) against horovod_tpu's, on the same seeded inputs and
converted weights.

Tolerances, float32 on both sides unless said:

* single layers (LayerNorm, Embed, DenseGeneral): 1e-5 — the same
  operations in other summation orders.
* whole-model logits: 2e-4 relative to the largest logit, the flash
  tests' own tolerance — several layers of float32 matmuls summed in
  other orders, and on the flash path the reference's blockwise online
  softmax against the port's plain version.
* bf16 logits against the reference's bf16 logits: 2e-2 relative to the
  largest, under three bf16 ulps (2^-7 each): the two frameworks round
  each bf16 product's sum at other places.
* training: the losses of 2 Adam steps to 1e-5, the parameters to 1e-6
  (float32 rounding of the update) except where the gradient is within
  rounding of 0.  Adam's first steps move a parameter by about
  lr·sign(g), so there the two frameworks may step it opposite ways, by
  up to 2·lr a step.  The attention's key bias is such a parameter: its
  exact gradient is 0, since adding q·b to every score of a row leaves
  the softmax unchanged, so both frameworks step it on rounding noise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu import training as ref_training
from horovod_tpu.models import bert as ref_bert
from horovod_tpu.models import gpt as ref_gpt
from horovod_tpu.ops.flash_attention import softmax_attention as ref_softmax
from horovod_tpu.optim import fused_update as ref_fu
from horovod_tpu.utils import flops as ref_flops
from horovod_tpu_torch import core, training
from horovod_tpu_torch.convert import (
    canonical_layouts, canonical_params, export_flax_variables,
    flatten_flax, fused_opt_state_from_flax, load_flax_variables,
)
from horovod_tpu_torch.models import (
    bert_base, bert_tiny, gpt2_small, gpt_tiny, next_token_loss,
)
from horovod_tpu_torch.models.layers import DenseGeneral, Embed, LayerNorm
from horovod_tpu_torch.ops.flash_attention import (
    flash_attention, softmax_attention,
)
from horovod_tpu_torch.optim.fused_update import fused_adam
from horovod_tpu_torch.utils import flops

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)

#: a small GPT for training: 2 layers, hidden 32, 4 heads, vocab 128
SMALL = dict(vocab_size=128, hidden_dim=32, num_layers=2, num_heads=4,
             mlp_dim=64, max_len=64)


@pytest.fixture(autouse=True)
def _on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def _randomized(params, seed):
    """Every leaf redrawn, so unit LayerNorm scales and zero biases do not
    hide a swapped or misnamed leaf."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        a = np.asarray(leaf)
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, params)


def _close_to_max(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_layernorm_matches_flax_not_torch():
    """eps 1e-6 and the fast variance E[x²] − E[x]², clamped at 0; the
    output in the compute dtype."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 16)) * 2 + 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    want = fnn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}},
                                 x)
    ln = LayerNorm(16)
    load_flax_variables(ln, {"scale": scale, "bias": bias})
    got = ln(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **LAYER_TOL)
    bf = LayerNorm(16, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert bf.dtype == torch.bfloat16
    # torch's own LayerNorm (eps 1e-5) is measurably different here
    x1 = np.full((1, 16), 1.0, np.float32)
    x1[0, 0] += 1e-3
    ours = LayerNorm(16)(torch.from_numpy(x1)).detach().numpy()
    theirs = torch.nn.functional.layer_norm(torch.from_numpy(x1),
                                            (16,)).numpy()
    np.testing.assert_allclose(ours, np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": np.ones(16, np.float32),
                    "bias": np.zeros(16, np.float32)}}, x1)), rtol=1e-4,
        atol=1e-4)
    assert not np.allclose(ours, theirs, atol=1e-2)


@pytest.mark.parametrize("in_shape,out_shape", [((12,), (3, 4)),
                                                ((3, 4), (12,))])
def test_dense_general_matches_flax(in_shape, out_shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5) + in_shape).astype(np.float32)
    axis = tuple(range(-len(in_shape), 0))
    ref = fnn.DenseGeneral(out_shape, axis=axis)
    variables = ref.init(jax.random.PRNGKey(0), x)
    variables = {"params": _randomized(variables["params"], 2)}
    layer = DenseGeneral(in_shape, out_shape)
    load_flax_variables(layer, variables["params"])
    got = layer(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply(variables, x)),
                               **LAYER_TOL)
    back = export_flax_variables(canonical_params(layer),
                                 canonical_layouts(layer))
    for k, a in flatten_flax(variables["params"]).items():
        assert np.array_equal(back[k], a), k


def test_embed_lookup_and_attend_match_flax():
    rng = np.random.default_rng(3)
    ref = fnn.Embed(50, 8)
    ids = rng.integers(0, 50, size=(2, 7))
    variables = ref.init(jax.random.PRNGKey(0), ids)
    q = rng.normal(size=(2, 7, 8)).astype(np.float32)
    emb = Embed(50, 8)
    load_flax_variables(emb, variables["params"])
    np.testing.assert_array_equal(
        emb(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(ref.apply(variables, ids)))
    np.testing.assert_allclose(
        emb.attend(torch.from_numpy(q)).detach().numpy(),
        np.asarray(ref.apply(variables, q, method=ref.attend)), **LAYER_TOL)
    # flax's promote_dtype: a bf16 Embed attends in bf16
    assert Embed(50, 8, dtype=torch.bfloat16).attend(
        torch.from_numpy(q)).dtype == torch.bfloat16


def test_initializers_follow_flax_distributions():
    gen = torch.Generator().manual_seed(0)
    model = gpt_tiny(generator=gen, dtype=torch.float32)
    p = canonical_params(model)
    assert abs(p["wte/embedding"].std().item() - (1 / 128) ** 0.5) < 3e-3
    k = p["EncoderLayer_0/SelfAttention_0/query/kernel"]   # fan_in 128
    assert abs(k.std().item() - (1 / 128) ** 0.5) < 3e-3
    assert k.abs().max().item() <= 2 * (1 / 128) ** 0.5 / 0.8796 + 1e-6
    assert torch.all(p["LayerNorm_0/scale"] == 1)
    assert torch.count_nonzero(p["EncoderLayer_1/Dense_0/bias"]) == 0
    again = canonical_params(gpt_tiny(generator=torch.Generator()
                                      .manual_seed(0), dtype=torch.float32))
    assert all(torch.equal(p[n], again[n]) for n in p)


# ---------------------------------------------------------------------------
# names, order and the converter
# ---------------------------------------------------------------------------
def _ref_shapes(model, seq):
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32)))["params"]


@pytest.mark.parametrize("family", ["gpt2_small", "bert_base"])
def test_canonical_names_and_order_match_jax_tree_util(family):
    ref, port = {"gpt2_small": (ref_gpt.gpt2_small, gpt2_small),
                 "bert_base": (ref_bert.bert_base, bert_base)}[family]
    leaves = jax.tree_util.tree_flatten_with_path(_ref_shapes(ref(), 8))[0]
    with torch.device("meta"):
        model = port()
    params, layouts = canonical_params(model), canonical_layouts(model)
    assert list(params) == ["/".join(k.key for k in p) for p, _ in leaves]
    assert [layouts[k].flax_shape for k in params] == \
        [tuple(leaf.shape) for _, leaf in leaves]
    # EncoderLayer_10 sorts before EncoderLayer_2, LayerNorm_0 before wpe
    names = list(params)
    assert names.index("EncoderLayer_10/Dense_0/bias") < \
        names.index("EncoderLayer_2/Dense_0/bias")
    if family == "gpt2_small":
        assert names[-2:] == ["wpe/embedding", "wte/embedding"]
        assert sum(t.numel() for t in params.values()) == 124_439_808


@functools.lru_cache(maxsize=None)
def _variables(family):
    """Randomized reference parameters of bert_tiny / gpt_tiny."""
    ref = {"gpt": ref_gpt.gpt_tiny, "bert": ref_bert.bert_tiny}[family](
        dtype=jnp.float32)
    params = ref.init(jax.random.PRNGKey(1),
                      jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, _randomized(params, 4))


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_flax_torch_flax_round_trip_is_exact(family):
    params = _variables(family)
    model = {"gpt": gpt_tiny, "bert": bert_tiny}[family](
        dtype=torch.float32)
    load_flax_variables(model, params)
    back = export_flax_variables(canonical_params(model),
                                 canonical_layouts(model))
    want = flatten_flax(params)
    assert list(back) == list(want)
    for k in want:
        assert back[k].shape == want[k].shape and \
            np.array_equal(back[k], want[k]), k


def test_export_needs_each_leafs_layout():
    """No rule by rank: a leaf without its module's layout raises (an
    Embed table would otherwise be transposed without a word)."""
    model = gpt_tiny(dtype=torch.float32)
    params, layouts = canonical_params(model), canonical_layouts(model)
    del layouts["wte/embedding"]
    with pytest.raises(ValueError, match="wte/embedding"):
        export_flax_variables(params, layouts)
    with pytest.raises(ValueError, match="wte/embedding"):
        fused_opt_state_from_flax(0, {}, {}, params, layouts)


def test_fused_adam_state_converts_to_the_reference_flat_buffers():
    """A reference fused-Adam state of GPT-tiny, two steps in, carried
    across: the port's next step equals the reference's next step in
    parameters and in both flat moment buffers."""
    params = _variables("gpt")
    rng = np.random.default_rng(8)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        for _ in range(3)]
    ref_opt, opt = ref_fu.fused_adam(1e-3), fused_adam(1e-3)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp)
    for g in grads[:2]:
        rp, rs = ref_opt.fused_update(g, rs, rp)

    model = gpt_tiny(dtype=torch.float32)
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray, rp))
    tp, layouts = canonical_params(model), canonical_layouts(model)
    ts = fused_opt_state_from_flax(rs.count, rs.mu, rs.nu, tp, layouts)
    assert int(ts.count) == 2
    tg = {k: torch.from_numpy(np.array(layouts[k].to_torch(a)))
          for k, a in flatten_flax(grads[2]).items()}
    rp, rs = ref_opt.fused_update(grads[2], rs, rp)
    with torch.no_grad():
        tp, ts = opt.fused_update(tg, ts, tp)
    got = export_flax_variables(tp, layouts)
    for k, a in flatten_flax(rp).items():
        np.testing.assert_allclose(got[k], a, rtol=2e-6, atol=1e-7,
                                   err_msg=k)
    back = fused_opt_state_from_flax(rs.count, rs.mu, rs.nu, tp, layouts)
    for name in ("mu", "nu"):
        np.testing.assert_allclose(getattr(ts, name)["float32"].numpy(),
                                   getattr(back, name)["float32"].numpy(),
                                   rtol=2e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
def _ids(seed, batch, seq, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, seq)).astype(np.int32)


@pytest.mark.parametrize("attn", ["flash", "materialized"])
def test_gpt_tiny_logits_match(attn):
    params = _variables("gpt")
    ids = _ids(0, 2, 40, 1024)
    if attn == "flash":
        ref, port_fn = ref_gpt.gpt_tiny(dtype=jnp.float32), None
    else:
        ref = ref_gpt.gpt_tiny(dtype=jnp.float32, attention_fn=(
            lambda q, k, v, m: ref_softmax(q, k, v, causal=True)))
        port_fn = lambda q, k, v, m: softmax_attention(q, k, v, causal=True)
    want = np.asarray(ref.apply({"params": params}, ids))
    model = gpt_tiny(dtype=torch.float32, attention_fn=port_fn)
    load_flax_variables(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 40, 1024)
    _close_to_max(got, want, 2e-4)


@pytest.mark.parametrize("attn", ["flash", "materialized"])
def test_bert_tiny_logits_match(attn):
    params = _variables("bert")
    ids = _ids(1, 2, 40, 1024)
    if attn == "flash":
        from horovod_tpu.ops.flash_attention import flash_attention as rf

        ref = ref_bert.bert_tiny(dtype=jnp.float32,
                                 attention_fn=lambda q, k, v, m: rf(q, k, v))
        port_fn = lambda q, k, v, m: flash_attention(q, k, v)
    else:
        ref, port_fn = ref_bert.bert_tiny(dtype=jnp.float32), None
    want = np.asarray(ref.apply({"params": params}, ids))
    model = bert_tiny(dtype=torch.float32, attention_fn=port_fn)
    load_flax_variables(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    _close_to_max(got, want, 2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_tiny_padding_mask_matches(dtype):
    """The materialized core's ``mask`` slot: a key-padding mask, with
    every key of the second sequence masked (a uniform row in both)."""
    params = _variables("bert")
    ids = _ids(3, 2, 24, 1024)
    keep = np.ones((2, 1, 1, 24), bool)
    keep[0, ..., 17:] = False
    keep[1] = False
    want = np.asarray(ref_bert.bert_tiny(dtype=jnp.dtype(dtype)).apply(
        {"params": params}, ids, keep))
    model = bert_tiny(dtype=getattr(torch, dtype))
    load_flax_variables(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(keep)).numpy()
    assert np.isfinite(got).all()
    _close_to_max(got, want, 2e-4 if dtype == "float32" else 2e-2)


def test_bf16_compute_keeps_the_residual_stream_in_bf16():
    """flax casts, not autocast: Dense, DenseGeneral, Embed and LayerNorm
    outputs are bf16, the parameters float32, the logits float32; and the
    bf16 logits stay close to the float32 model's."""
    params = _variables("gpt")
    ids = torch.from_numpy(_ids(2, 1, 24, 1024)).long()
    seen = []
    model = gpt_tiny(dtype=torch.bfloat16)
    load_flax_variables(model, params)
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
             for m in model.modules()
             if isinstance(m, (LayerNorm, DenseGeneral, Embed))]
    with torch.no_grad():
        logits = model(ids)
    for h in hooks:
        h.remove()
    assert set(seen) == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert logits.dtype == torch.float32
    f32 = gpt_tiny(dtype=torch.float32)
    load_flax_variables(f32, params)
    with torch.no_grad():
        _close_to_max(logits.numpy(), f32(ids).numpy(), 0.1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def test_next_token_loss_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 9, 17)).astype(np.float32)
    ids = rng.integers(0, 17, size=(2, 9)).astype(np.int32)
    want = float(ref_gpt.next_token_loss(jnp.asarray(logits),
                                         jnp.asarray(ids)))
    got = next_token_loss(torch.from_numpy(logits),
                          torch.from_numpy(ids)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


def test_transformer_mfu_and_param_count_match_reference():
    params = _variables("gpt")
    model = gpt_tiny(dtype=torch.float32)
    n = flops.param_count(canonical_params(model))
    assert n == ref_flops.param_count(params)
    for causal in (True, False):
        assert flops.transformer_train_flops_per_seq(
            n, 4, 128, 512, causal=causal) == \
            ref_flops.transformer_train_flops_per_seq(n, 4, 128, 512,
                                                      causal=causal)
        assert flops.transformer_mfu(57.5, n, 4, 128, 512, causal=causal,
                                     peak_flops=989e12) == \
            pytest.approx(ref_flops.transformer_mfu(
                57.5, n, 4, 128, 512, causal=causal, peak_flops=989e12),
                rel=1e-12)
    # the port divides by the H100's peak, the reference by the v5e's
    assert flops.transformer_mfu(1.0, n, 4, 128, 512) == pytest.approx(
        flops.transformer_train_flops_per_seq(n, 4, 128, 512) / 989e12)


STEPS, LR = 2, 1e-3


def _reference_train(params, ids):
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        model = ref_gpt.GPT(dtype=jnp.float32, **SMALL)
        opt = ref_fu.fused_adam(LR)
        step = ref_training.make_train_step(
            apply_fn=lambda v, x, train=True: model.apply(v, x),
            loss_fn=ref_gpt.next_token_loss, optimizer=opt,
            fused_optimizer=True, loss_fetch_steps=0)
        state = ref_training.TrainState(
            params=params, opt_state=opt.init(params), model_state={},
            step=jnp.zeros((), jnp.int32))
        state = jax.device_put(state, NamedSharding(hvd.core.mesh(), P()))
        x = ref_training.shard_batch(ids)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, x, x)
            losses.append(float(jax.device_get(loss)))
        return np.asarray(losses), flatten_flax(state.params)
    finally:
        hvd.shutdown()


def test_gpt_training_steps_match_reference(port_cpu_world):
    """2 steps of fused Adam through both packages' make_train_step on one
    rank, from the same weights and ids; the tied embedding's gradient
    flows from the lookup and the head alike."""
    ref = ref_gpt.GPT(dtype=jnp.float32, **SMALL)
    ids = _ids(9, 4, 24, SMALL["vocab_size"])
    params = jax.tree_util.tree_map(np.asarray, _randomized(ref.init(
        jax.random.PRNGKey(2), ids)["params"], 10))
    want_losses, want = _reference_train(params, ids)

    model = gpt_tiny(dtype=torch.float32, **SMALL)
    load_flax_variables(model, params)
    opt = fused_adam(LR)
    step = training.make_train_step(apply_fn=model, loss_fn=next_token_loss,
                                    optimizer=opt, loss_fetch_steps=0)
    state = training.init_train_state(model, opt)
    x = training.shard_batch(torch.from_numpy(ids).long())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, x, x)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = export_flax_variables(state.params, canonical_layouts(model))
    assert list(got) == list(want)
    for k in want:
        bound = 2 * LR * STEPS if k.endswith("key/bias") else 1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=bound,
                                   err_msg=k)
    # the tied head trained the whole embedding table, rows never looked
    # up included (their gradient comes from the head alone)
    moved = np.abs(got["wte/embedding"] - flatten_flax(params)[
        "wte/embedding"]).max(axis=1)
    assert (moved > 0).all()


def test_gpt_benchmark_runs_on_cpu(monkeypatch):
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    try:
        out = gb.run(gb.parse_args([
            "--model", "tiny", "--batch-size", "2", "--seq-len", "64",
            "--num-warmup-batches", "1", "--num-batches-per-iter", "2",
            "--num-iters", "2", "--device", "cpu"]))
    finally:
        core.shutdown()
    assert set(out) == {"seq_sec_per_chip", "mfu", "final_loss",
                        "step_calls"}
    assert np.isfinite(out["final_loss"]) and out["seq_sec_per_chip"] > 0
    assert out["mfu"] is None     # no fraction of the card's peak on a CPU


def test_gpt_benchmark_defaults_are_the_references():
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    a = gb.parse_args([])
    assert (a.model, a.batch_size, a.seq_len, a.dtype, a.attn,
            a.num_warmup_batches, a.num_batches_per_iter, a.num_iters) == \
        ("gpt2", 4, 1024, "bfloat16", "flash", 2, 5, 3)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_gpt_benchmark_sequence_parallel_raises(mode, monkeypatch):
    """``--seq-parallel`` raised until sequence parallelism was ported;
    now it runs, and at world size 1 (the whole sequence on one rank, the
    ring's one hop and Ulysses' exchanges the identity) its final loss
    equals the data-parallel run's to float32 rounding."""
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--model", "tiny", "--batch-size", "2", "--seq-len", "64",
            "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
            "--num-iters", "1", "--dtype", "float32", "--device", "cpu"]
    losses = []
    for sp in (mode, "none"):
        core.shutdown()
        try:
            losses.append(gb.run(gb.parse_args(
                argv + ["--seq-parallel", sp]))["final_loss"])
        finally:
            core.shutdown()
    assert np.isfinite(losses[0])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
