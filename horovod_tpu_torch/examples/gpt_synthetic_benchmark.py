"""GPT (decoder LM) synthetic benchmark: the port of
``examples/gpt_synthetic_benchmark.py``.

Trains GPT-2 small (or the tiny variant) data-parallel on one synthetic
batch of token ids and reports sequences per second per card and MFU,
with the reference's CLI and defaults (batch 4 per rank, seq 1024,
bf16, 2 warm-up steps, 3 iterations of 5) plus ``--device``.  The ids
are the reference's, ``np.random.default_rng(0).integers(0, 1000)``;
the weights come from a generator on the device seeded with 0.

* ``--attn flash`` (the reference's ``pallas``, the default): causal
  attention through the hand-written kernels K2-K4.
* ``--attn torch`` (the reference's ``xla``): the materialized
  ``softmax_attention``.
* ``--seq-parallel ring|ulysses``: the reference's sequence
  parallelism.  The sequence is sharded over the world and the batch
  (``--batch-size`` sequences, the reference's draw) replicated; the
  model sees global positions (``seq_offset``), attention is
  ``ring_attention`` or ``ulysses_attention`` (``parallel/``, the flash
  kernels per hop with ``--attn flash``), and the loss is the shifted LM
  loss within each shard, the ``n - 1`` predictions across shard
  boundaries dropped as the reference drops them, averaged over the
  ranks with the gradients.  As the reference's sequence-parallel step
  it runs one optimizer step a call (``--num-in-graph-steps`` applies
  to the data-parallel path only), and the rate counts ``--batch-size``
  sequences for the whole world.

The optimizer differs from the reference's.  The reference trains with
``optax.adam(1e-4)``; the port's trainer takes a ``FusedOptimizer``, so
this runs ``fused_adam(1e-4)``, the JAX package's own fused Adam, which
computes optax's ``scale_by_adam`` expression for expression, here
through K1's adam rule over one flat float32 buffer.

On a card the step is the compiled one (the first warm-up call eager,
the second captures ``--num-in-graph-steps`` steps into a CUDA graph,
the rest replay it), so at the default two warm-up batches the timed
window holds only replays.

Run:  python -m horovod_tpu_torch.examples.gpt_synthetic_benchmark --seq-len 1024
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import core
from ..models.gpt import gpt2_small, gpt_tiny, next_token_loss
from ..ops.flash_attention import softmax_attention
from ..optim.fused_update import fused_adam
from ..parallel.ring_attention import ring_attention, ulysses_attention
from ..training import (
    init_train_state, make_train_step, shard_batch, shard_sequence,
)
from ..utils.flops import param_count, transformer_mfu

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="horovod_tpu_torch GPT synthetic benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--model", choices=["tiny", "gpt2"], default="gpt2")
    parser.add_argument("--batch-size", type=int, default=4,
                        help="per-rank sequences")
    parser.add_argument("--seq-len", type=int, default=1024)
    parser.add_argument("--attn", choices=["flash", "torch"],
                        default="flash",
                        help="flash: kernels K2-K4; torch: materialized "
                             "softmax attention")
    parser.add_argument("--seq-parallel", choices=["none", "ring", "ulysses"],
                        default="none")
    parser.add_argument("--num-warmup-batches", type=int, default=2)
    parser.add_argument("--num-batches-per-iter", type=int, default=5)
    parser.add_argument("--num-iters", type=int, default=3)
    parser.add_argument("--dtype", choices=sorted(_DTYPES),
                        default="bfloat16")
    parser.add_argument("--num-in-graph-steps", type=int, default=1,
                        help="optimizer steps per call of the step")
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' to run on the CPU; default: this "
                             "rank's CUDA device")
    return parser.parse_args(argv)


def _attention_fn(args):
    impl = "flash" if args.attn == "flash" else "xla"
    if args.seq_parallel == "ring":
        return lambda q, k, v, m: ring_attention(q, k, v, causal=True,
                                                 impl=impl)
    if args.seq_parallel == "ulysses":
        return lambda q, k, v, m: ulysses_attention(q, k, v, causal=True,
                                                    impl=impl)
    if args.attn == "flash":
        return None  # the model's default: causal flash attention
    return lambda q, k, v, m: softmax_attention(q, k, v, causal=True)


def run(args, eager: bool = False,
        then: Optional[Callable] = None) -> dict:
    """The benchmark; ``eager`` times ``step.eager``, the same step never
    captured, instead of the step (to compare the two).  ``then(step,
    state, x, y)``, when given, is called after the timed window with the
    step that was timed, its state and its inputs (``chip_smoke.py``
    traces more calls with it); what it returns is the result's
    ``"then"``."""
    core.init(device=args.device)
    factory = gpt2_small if args.model == "gpt2" else gpt_tiny
    # initialized on the device, from a generator there seeded with 0
    with torch.device(core.device()):
        model = factory(dtype=_DTYPES[args.dtype],
                        attention_fn=_attention_fn(args),
                        max_len=max(args.seq_len, 1024),
                        generator=torch.Generator(
                            device=core.device()).manual_seed(0))
    opt = fused_adam(1e-4)
    rng = np.random.default_rng(0)
    if args.seq_parallel == "none":
        apply_fn, k = model, max(args.num_in_graph_steps, 1)
        ids = shard_batch(torch.from_numpy(rng.integers(
            0, 1000, size=(args.batch_size * core.size(), args.seq_len))))
        n_batches = args.batch_size * core.size()
    else:
        ids = shard_sequence(torch.from_numpy(rng.integers(
            0, 1000, size=(args.batch_size, args.seq_len))))
        off = core.rank() * ids.shape[1]
        apply_fn, k = (lambda x: model(x, seq_offset=off)), 1
        n_batches = args.batch_size
    step = make_train_step(apply_fn=apply_fn, loss_fn=next_token_loss,
                           optimizer=opt, in_graph_steps=k)
    state = init_train_state(model, opt)
    run_step = step.eager if eager else step

    def log(s):
        if core.rank() == 0:
            print(s, flush=True)

    log(f"Model: gpt-{args.model}  seq {args.seq_len}  attn {args.attn}  "
        f"sp {args.seq_parallel}  device {core.device()}")
    # Reading the loss waits for the whole chain of steps queued before it.
    for _ in range(max(args.num_warmup_batches, 1)):
        state, loss = run_step(state, ids, ids)
    loss.item()

    rates = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            state, loss = run_step(state, ids, ids)
        loss.item()
        dt = time.perf_counter() - t0
        rate = n_batches * k * args.num_batches_per_iter / dt
        log(f"Iter: sequences/sec total: {rate:.1f}")
        rates.append(rate)

    calls, final_loss = dict(step.calls), float(loss.item())
    after = then(run_step, state, ids, ids) if then is not None else None
    per_chip = float(np.mean(rates)) / core.size()
    mfu = None  # a rate of the CPU is no fraction of the card's peak
    if core.device().type == "cuda":
        mfu = transformer_mfu(per_chip, param_count(state.params),
                              model.num_layers, model.hidden_dim,
                              args.seq_len, causal=True)
        log(f"analytic MFU {mfu:.1%} of the H100 bf16 peak")
    log(f"sequences/sec per chip: {per_chip:.1f}")
    return {"seq_sec_per_chip": per_chip, "mfu": mfu,
            "final_loss": final_loss, "step_calls": calls,
            **({"then": after} if then is not None else {})}


if __name__ == "__main__":
    run(parse_args())
