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

``--cuda-trace`` captures a torch.profiler trace of the timeline's step
window (``HVD_TRACE_DIR`` with ``HVD_TRACE_START_STEP`` /
``HVD_TRACE_END_STEP``), which on a card shows what the graph's replays
ran.  Run as a program, rank 0 prints the result as one JSON line last,
with the launches of K1-K4 that the wrappers issued, and every rank
records it as a ``bench.result`` flight-recorder event.

Run:  python -m horovod_tpu_torch.examples.gpt_synthetic_benchmark --seq-len 1024
"""

from __future__ import annotations

import argparse
import json
import os
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
    parser.add_argument("--cuda-trace", action="store_true",
                        help="capture a torch.profiler trace of the "
                             "timeline's step window (HVD_TRACE_DIR, "
                             "HVD_TRACE_START_STEP / _END_STEP) into "
                             "<trace dir>/<rank>/cuda_trace/trace.json")
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


def window_traced(run_step: Callable) -> Callable:
    """``run_step`` with a torch.profiler capture (the profiler's
    ``_start_cuda_trace``, CUPTI on a card) over the calls of the
    timeline's step window, written to ``<rank dir>/cuda_trace/
    trace.json`` after the window's last call: on a card, the kernels
    the graph's replays ran.  Without an open timeline it traces
    nothing."""
    from ..timeline.profiler import (
        CUDA_TRACE_DIR, _start_cuda_trace, _stop_cuda_trace,
    )
    from ..timeline.timeline import timeline

    box = {"prof": None, "dir": None}

    def call(state, x, y):
        n = timeline.steps + 1        # the number record_step gives it
        start, end = timeline.window
        if timeline.active and n == start and box["dir"] is None:
            box["dir"] = timeline.rank_dir
            box["prof"] = _start_cuda_trace()
        out = run_step(state, x, y)
        if box["prof"] is not None and n == end:
            _stop_cuda_trace(box["prof"],
                             os.path.join(box["dir"], CUDA_TRACE_DIR))
            box["prof"] = None
        return out

    return call


def run(args, eager: bool = False,
        then: Optional[Callable] = None) -> dict:
    """The benchmark; ``eager`` times ``step.eager``, the same step never
    captured, instead of the step (to compare the two).  ``then(step,
    state, x, y)``, when given, is called after the timed window with the
    step that was timed, its state and its inputs (``chip_smoke.py``
    traces more calls with it); what it returns is the result's
    ``"then"``.  ``"rates"`` are the iterations' seq/s per card."""
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
    if getattr(args, "cuda_trace", False):
        run_step = window_traced(run_step)

    def log(s):
        if core.rank() == 0:
            print(s, flush=True)

    log(f"Model: gpt-{args.model}  seq {args.seq_len}  attn {args.attn}  "
        f"sp {args.seq_parallel}  device {core.device()}")
    # Reading the loss waits for the whole chain of steps queued before it.
    first_step_at = time.time()
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
            "rates": [r / core.size() for r in rates],
            "final_loss": final_loss, "step_calls": calls,
            "first_step_at": first_step_at, "device": str(core.device()),
            **({"then": after} if then is not None else {})}


def summary(result: dict) -> dict:
    """The run's result with the launches its wrappers issued (K1 by
    rule, K2-K4 by kind and mainloop): the line a launched worker prints
    last, for whoever launched it."""
    from .. import kernels

    return {"gpt_synthetic_benchmark": {
        **result, "rank": core.rank(), "size": core.size(),
        "k1_launches_issued": kernels.launch_totals(
            kernels.fused_update_launches),
        "flash_launches_issued": {k: v for k, v in
                                  kernels.flash_launches.items() if v}}}


if __name__ == "__main__":
    from ..observe import events

    _args = parse_args()
    _result = run(_args)
    # the run's result in the flight recorder too: under a launcher its
    # flusher lands it in the rendezvous server's events scope
    events.record_event("bench.result", payload={
        "model": _args.model, "seq_sec_per_chip": _result["seq_sec_per_chip"],
        "final_loss": _result["final_loss"], "device": _result["device"]})
    if core.rank() == 0:
        print(json.dumps(summary(_result)), flush=True)
