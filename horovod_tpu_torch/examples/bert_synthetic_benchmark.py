"""BERT synthetic benchmark, masked-LM pretraining throughput: the port
of ``examples/bert_synthetic_benchmark.py``.

Trains the BERT encoder (base, or the tiny variant) data-parallel on one
synthetic batch and reports sentences per second per card and MFU, with
the reference's CLI and defaults (BERT-base, batch 8 per rank, seq 512,
bf16, 3 warm-up steps, 5 iterations of 5) plus ``--device``.  As in the
reference:

* the tokens are ``synthetic_tokens`` (``default_rng(99)``, ids below the
  vocabulary size) and the MLM mask ``default_rng(5).uniform < mask_prob``,
  the masked inputs replaced by the id ``vocab - 1``;
* the MLM head is a fixed float32 ``[hidden, vocab]`` matrix, normal with
  stddev 0.02, outside the parameters: it gets no gradient, no
  all-reduce and no place in the fusion buckets.  Its draws are torch's
  (a generator seeded with 1), not the reference's ``PRNGKey(1)``;
* ``hidden @ head`` is a float32 product (TF32 stays off, torch's
  default), and the loss is the masked mean cross-entropy over
  ``max(mask.sum(), 1)``.  The step's ``y`` carries the targets and the
  mask stacked on a last axis (``mlm_targets``);
* the optimizer is ``optax.adamw(1e-4)``'s port, ``transforms.adamw``,
  leaf by leaf.

``--attn pallas`` runs non-causal flash attention, the kernels K2-K4;
``--attn xla`` the encoder's materialized attention.  ``--adasum``
reduces each gradient with ``allreduce(op=Adasum)`` inside the step, as
the reference's bench does.  ``--seq-parallel ring|ulysses`` shards the
sequence over the world, every rank holding all ``batch · size``
sentences, and attends with ``ring_attention`` or ``ulysses_attention``
(``parallel/``; the flash kernels per hop with ``--attn pallas``),
non-causal.  As in the reference the encoder is called on each shard as
it is, so its positions restart at 0 in every shard, and each rank's
masked loss is its own shard's, averaged over the ranks.

On a card the step is the compiled one (the first warm-up call eager,
the second captures ``--num-in-graph-steps`` steps into a CUDA graph,
the rest replay it), so with two or more warm-up batches the timed
window holds only replays.

Run:  python -m horovod_tpu_torch.examples.bert_synthetic_benchmark --attn pallas
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import core
from ..models.bert import bert_base, bert_tiny
from ..ops.flash_attention import flash_attention
from ..optim.transforms import adamw
from ..parallel.ring_attention import ring_attention, ulysses_attention
from ..training import (
    init_train_state, make_train_step, shard_batch, shard_sequence,
)
from ..utils.flops import param_count, transformer_mfu

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="horovod_tpu_torch BERT synthetic benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", choices=["tiny", "base"], default="base")
    p.add_argument("--batch-size", type=int, default=8,
                   help="per-rank sentences")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--attn", choices=["xla", "pallas"], default="xla",
                   help="pallas: non-causal flash attention (K2-K4); xla: "
                        "the materialized attention")
    p.add_argument("--seq-parallel", choices=["none", "ring", "ulysses"],
                   default="none")
    p.add_argument("--mask-prob", type=float, default=0.15)
    p.add_argument("--num-warmup-batches", type=int, default=3)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=5)
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    p.add_argument("--adasum", action="store_true", default=False,
                   help="Adasum gradient reduction")
    p.add_argument("--num-in-graph-steps", type=int, default=1,
                   help="optimizer steps per call of the step")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' to run on the CPU; default: this rank's "
                        "CUDA device")
    return p.parse_args(argv)


def synthetic_tokens(n: int = 1024, seq_len: int = 128, vocab: int = 1024,
                     seed: int = 99) -> np.ndarray:
    """Token-id sequences ``[n, seq_len]`` int32 (the reference's
    ``examples/datasets.py`` ``synthetic_tokens``)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(n, seq_len)).astype(np.int32)


def mlm_batch(n: int, seq_len: int, vocab: int, mask_prob: float):
    """The reference's masked-LM data: ``(inputs, targets, mask)`` numpy
    arrays, ``[4n, seq_len]`` each; the benchmark trains on the first
    ``n`` rows."""
    tokens = synthetic_tokens(n=n * 4, seq_len=seq_len, vocab=vocab)
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=tokens.shape) < mask_prob
    inputs = np.where(mask, vocab - 1, tokens).astype(np.int32)
    return inputs, tokens, mask


def mlm_targets(targets, mask) -> torch.Tensor:
    """The step's ``y``: targets and mask stacked on a last axis,
    ``[b, s, 2]`` int64 (one tensor, as a captured step's input must
    be)."""
    return torch.stack([torch.as_tensor(targets).long(),
                        torch.as_tensor(mask).long()], dim=-1)


def masked_mlm_loss(logits, y):
    """Masked mean cross-entropy: the sum over masked positions over
    ``max(mask.sum(), 1)``, in float32."""
    targets, mask = y[..., 0], y[..., 1].float()
    raw = F.cross_entropy(logits.flatten(0, -2).float(), targets.flatten(),
                          reduction="none").view_as(mask)
    return (raw * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def mlm_apply(model, head: torch.Tensor) -> Callable:
    """``ids -> hidden @ head``: the encoder's float32 features through
    the fixed float32 head."""
    def apply(ids):
        return torch.matmul(model(ids), head)

    return apply


def mlm_head(hidden: int, vocab: int, device) -> torch.Tensor:
    """The fixed float32 MLM head ``[hidden, vocab]``, normal with stddev
    0.02, from a torch generator seeded with 1."""
    return (torch.randn(hidden, vocab,
                        generator=torch.Generator().manual_seed(1))
            * 0.02).to(device)


def _attention_fn(args):
    impl = "flash" if args.attn == "pallas" else "xla"
    if args.seq_parallel == "ring":
        return lambda q, k, v, mask: ring_attention(q, k, v, causal=False,
                                                    impl=impl)
    if args.seq_parallel == "ulysses":
        return lambda q, k, v, mask: ulysses_attention(
            q, k, v, causal=False, impl=impl)
    if args.attn == "pallas":
        return lambda q, k, v, mask: flash_attention(q, k, v, causal=False)
    return None  # the encoder's materialized attention


def run(args, eager: bool = False,
        then: Optional[Callable] = None) -> dict:
    """The benchmark; ``eager`` times ``step.eager``, the same step never
    captured, instead of the step (to compare the two).  ``then(step,
    state, x, y)``, when given, is called after the timed window with the
    step that was timed, its state and its inputs (``chip_smoke.py``
    traces more calls with it); what it returns is the result's
    ``"then"``."""
    core.init(device=args.device)
    factory = bert_tiny if args.model == "tiny" else bert_base
    # initialized on the device, from a generator there seeded with 0
    with torch.device(core.device()):
        model = factory(dtype=_DTYPES[args.dtype],
                        attention_fn=_attention_fn(args),
                        max_len=max(args.seq_len, 512),
                        generator=torch.Generator(
                            device=core.device()).manual_seed(0))
    vocab = model.vocab_size
    opt = adamw(1e-4)
    state = init_train_state(model, opt)
    head = mlm_head(model.hidden_dim, vocab, core.device())
    step = make_train_step(apply_fn=mlm_apply(model, head),
                           loss_fn=masked_mlm_loss, optimizer=opt,
                           op=core.Adasum if args.adasum else core.Average,
                           in_graph_steps=args.num_in_graph_steps)
    run_step = step.eager if eager else step

    n = args.batch_size * core.size()
    inputs, tokens, mask = mlm_batch(n, args.seq_len, vocab, args.mask_prob)
    # the batch sharded over the world, or (sequence parallel) the
    # sequence, every rank holding all n sentences
    shard = shard_batch if args.seq_parallel == "none" else shard_sequence
    x = shard(torch.from_numpy(inputs[:n]).long())
    y = shard(mlm_targets(tokens[:n], mask[:n]))

    def log(s):
        if core.rank() == 0:
            print(s, flush=True)

    log(f"Model: bert-{args.model}  seq {args.seq_len}  attn {args.attn}  "
        f"sp {args.seq_parallel}  adasum {args.adasum}  "
        f"device {core.device()}")
    # Reading the loss waits for the whole chain of steps queued before it.
    for _ in range(max(args.num_warmup_batches, 1)):
        state, loss = run_step(state, x, y)
    loss.item()

    rates = []
    k = max(args.num_in_graph_steps, 1)
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            state, loss = run_step(state, x, y)
        loss.item()
        dt = time.perf_counter() - t0
        rate = n * k * args.num_batches_per_iter / dt
        log(f"Iter: sentences/sec total: {rate:.1f}")
        rates.append(rate)

    calls, final_loss = dict(step.calls), float(loss.item())
    after = then(run_step, state, x, y) if then is not None else None
    per_chip = float(np.mean(rates)) / core.size()
    mfu = None  # a rate of the CPU is no fraction of the card's peak
    if core.device().type == "cuda":
        # the head's products run every step: count its parameters too
        mfu = transformer_mfu(per_chip,
                              param_count(state.params) + head.numel(),
                              model.num_layers, model.hidden_dim,
                              args.seq_len)
        log(f"analytic MFU {mfu:.1%} of the H100 bf16 peak")
    log(f"sentences/sec per chip: {per_chip:.1f}")
    return {"sent_sec_per_chip": per_chip, "mfu": mfu,
            "final_loss": final_loss, "step_calls": calls,
            **({"then": after} if then is not None else {})}


if __name__ == "__main__":
    run(parse_args())
