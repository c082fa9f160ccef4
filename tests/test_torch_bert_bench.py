"""The port's BERT benchmark (examples/bert_synthetic_benchmark.py)
against the reference's: its data, its masked loss, and 3 AdamW steps of
bert_tiny through the port's make_train_step against the reference's
step built as ``examples/bert_synthetic_benchmark.py`` builds it (the
masked loss over ``hidden @ head``, ``allreduce_pytree``, the loss
all-reduce, ``optax.adamw(1e-4)`` and ``optax.apply_updates`` under
``hvd.spmd``), from the same weights, head and batch, float32 on both
sides.

Tolerances, as the card's GPT training parity (chip_smoke.py
``GPT_PARAM_ATOL``, ``GPT_FLIP_*``): losses to 1e-5 (float32 summation
order); parameters to 1e-6 absolute.  Adam's first steps move each
parameter by about lr·sign(g), so where a gradient is within rounding of
0 the two frameworks may step it opposite ways, by up to 2·lr a step:
every parameter is held to that, and at most 1e-4 of them (measured: 1
of 726,272) may differ by more than 1e-6.  The attention's key bias has
an exact gradient of 0 (adding q·b to every score of a row leaves the
softmax unchanged), so both frameworks step it on rounding noise: it is
held to 2·lr a step alone.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.models import bert as ref_bert
from horovod_tpu.ops.fusion import allreduce_pytree
from horovod_tpu_torch import core, training
from horovod_tpu_torch.convert import (
    canonical_layouts, export_flax_variables, flatten_flax,
    load_flax_variables,
)
from horovod_tpu_torch.examples import bert_synthetic_benchmark as bb
from horovod_tpu_torch.models import bert_tiny
from horovod_tpu_torch.optim.transforms import adamw

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples.datasets import synthetic_tokens as ref_tokens  # noqa: E402

STEPS, LR = 3, 1e-4
PARAM_ATOL, FLIP_BOUND, FLIP_SHARE = 1e-6, 2 * LR * STEPS, 1e-4
BATCH, SEQ = 2, 40


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


def test_data_is_the_references():
    """The tokens are the reference's ``synthetic_tokens`` and the mask
    and masked inputs its ``default_rng(5)`` draw."""
    vocab = 1024
    inputs, tokens, mask = bb.mlm_batch(BATCH, SEQ, vocab, 0.15)
    want = ref_tokens(n=BATCH * 4, seq_len=SEQ, vocab=vocab)
    np.testing.assert_array_equal(tokens, want)
    want_mask = np.random.default_rng(5).uniform(size=want.shape) < 0.15
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(inputs,
                                  np.where(want_mask, vocab - 1, want))
    assert mask.any() and not mask.all()


def _ref_masked_loss(logits, ids_tgt, mask):
    raw = optax.softmax_cross_entropy_with_integer_labels(logits, ids_tgt)
    return (raw * mask).sum() / jnp.maximum(mask.sum(), 1)


@pytest.mark.parametrize("masked", [0.15, 0.0])
def test_masked_loss_matches_reference(masked):
    """Including a batch with nothing masked (the denominator's floor)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 7, 33)).astype(np.float32)
    tgt = rng.integers(0, 33, size=(2, 7))
    mask = rng.uniform(size=(2, 7)) < masked
    want = float(_ref_masked_loss(jnp.asarray(logits), jnp.asarray(tgt),
                                  jnp.asarray(mask, jnp.float32)))
    got = bb.masked_mlm_loss(torch.from_numpy(logits),
                             bb.mlm_targets(tgt, mask)).item()
    assert abs(got - want) <= 1e-6 * max(abs(want), 1e-6)


def _reference_train(params, head, ids_in, ids_tgt, m):
    """The reference bench's step (bert_synthetic_benchmark.py:111-141)
    on one CPU device: losses and parameters after each step."""
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        model = ref_bert.bert_tiny(dtype=jnp.float32)
        opt = optax.adamw(LR)
        opt_state = opt.init(params)

        def loss_fn(params, head, ids_in, ids_tgt, mask):
            hidden = model.apply({"params": params}, ids_in)
            return _ref_masked_loss(hidden @ head, ids_tgt, mask)

        @hvd.spmd(in_specs=(P(), P(), P(hvd.AXIS), P(hvd.AXIS),
                            P(hvd.AXIS)),
                  out_specs=(P(), P(), P()))
        def train_step(params, opt_state, ids_in, ids_tgt, m):
            from horovod_tpu.ops import collectives

            loss, grads = jax.value_and_grad(loss_fn)(params, head, ids_in,
                                                      ids_tgt, m)
            grads = allreduce_pytree(grads, op=hvd.Average)
            loss = collectives.allreduce(loss, op=hvd.Average)
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        losses = []
        for _ in range(STEPS):
            params, opt_state, loss = train_step(params, opt_state, ids_in,
                                                 ids_tgt, m)
            losses.append(float(jax.device_get(loss)))
        return np.asarray(losses), flatten_flax(params)
    finally:
        hvd.shutdown()


def test_bert_tiny_adamw_steps_match_reference(port_cpu_world):
    ref = ref_bert.bert_tiny(dtype=jnp.float32)
    vocab = ref.vocab_size
    inputs, tokens, mask = bb.mlm_batch(BATCH, SEQ, vocab, 0.15)
    ids_in, ids_tgt = inputs[:BATCH], tokens[:BATCH]
    m = mask[:BATCH].astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, ref.init(
        jax.random.PRNGKey(0), ids_in[:1])["params"])
    head = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (ref.hidden_dim, vocab), jnp.float32) * 0.02)
    want_losses, want = _reference_train(params, head, ids_in, ids_tgt, m)

    model = bert_tiny(dtype=torch.float32)
    load_flax_variables(model, params)
    opt = adamw(LR)
    step = training.make_train_step(
        apply_fn=bb.mlm_apply(model, torch.from_numpy(np.array(head))),
        loss_fn=bb.masked_mlm_loss, optimizer=opt, loss_fetch_steps=0)
    state = training.init_train_state(model, opt)
    x = training.shard_batch(torch.from_numpy(ids_in).long())
    y = training.shard_batch(bb.mlm_targets(ids_tgt, mask[:BATCH]))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, x, y)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    got = export_flax_variables(state.params, canonical_layouts(model))
    assert list(got) == list(want)
    start = flatten_flax(params)
    flipped = total = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=FLIP_BOUND,
                                   err_msg=k)
        if not k.endswith("key/bias"):
            flipped += int((np.abs(got[k] - want[k]) > PARAM_ATOL).sum())
            total += want[k].size
        assert not np.array_equal(got[k], start[k]), k  # every leaf trained
    assert flipped <= FLIP_SHARE * total, (flipped, total)
    # the head is the bench's fixed matrix, not a parameter
    assert int(state.opt_state[0].count) == STEPS
    assert not any(t.shape == (ref.hidden_dim, vocab)
                   for t in state.params.values())


def test_bert_benchmark_runs_on_cpu(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    try:
        out = bb.run(bb.parse_args([
            "--model", "tiny", "--batch-size", "2", "--seq-len", "64",
            "--attn", "pallas", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "2", "--num-iters", "2",
            "--device", "cpu"]))
    finally:
        core.shutdown()
    assert set(out) == {"sent_sec_per_chip", "mfu", "final_loss",
                        "step_calls"}
    assert out["step_calls"] == {"eager": 5, "capture": 0, "replay": 0}
    assert np.isfinite(out["final_loss"]) and out["sent_sec_per_chip"] > 0
    assert out["mfu"] is None     # no fraction of the card's peak on a CPU


def test_bert_benchmark_defaults_are_the_references():
    a = bb.parse_args([])
    assert (a.model, a.batch_size, a.seq_len, a.dtype, a.attn, a.mask_prob,
            a.num_warmup_batches, a.num_batches_per_iter, a.num_iters) == \
        ("base", 8, 512, "bfloat16", "xla", 0.15, 3, 5, 5)


@pytest.mark.parametrize("argv,item", [
    (["--seq-parallel", "ring"], "item 9"),
    (["--seq-parallel", "ulysses"], "item 9"),
])
def test_unported_options_raise(argv, item, monkeypatch):
    """``--seq-parallel`` raised until ROADMAP queue 1 ``item`` (sequence
    parallelism) was ported; now it runs, and at world size 1 (the ring's
    one hop and Ulysses' exchanges the identity) its final loss equals
    the data-parallel run's to float32 rounding, on the flash path."""
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    base = ["--model", "tiny", "--batch-size", "2", "--seq-len", "64",
            "--attn", "pallas", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "1", "--num-iters", "1",
            "--dtype", "float32", "--device", "cpu"]
    losses = []
    for extra in (argv, []):
        core.shutdown()
        try:
            losses.append(bb.run(bb.parse_args(base + extra))["final_loss"])
        finally:
            core.shutdown()
    assert np.isfinite(losses[0]), item
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


def test_adasum_runs_in_the_step_and_is_the_identity_at_one_rank(
        monkeypatch):
    """``--adasum`` reduces each gradient with ``allreduce(op=Adasum)``
    in the step (as the reference's bench); at one rank that is the
    identity, so the losses equal the default run's bit for bit."""
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--model", "tiny", "--batch-size", "2", "--seq-len", "64",
            "--attn", "pallas", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "1", "--num-iters", "2",
            "--device", "cpu"]
    losses = []
    for extra in (["--adasum"], []):
        core.shutdown()
        try:
            out = bb.run(bb.parse_args(argv + extra))
        finally:
            core.shutdown()
        assert np.isfinite(out["final_loss"])
        losses.append(out["final_loss"])
    assert losses[0] == losses[1]
