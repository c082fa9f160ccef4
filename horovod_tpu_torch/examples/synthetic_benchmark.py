"""Synthetic benchmark: the port of ``examples/synthetic_benchmark.py``.

Trains a ResNet data-parallel on one synthetic batch and reports images
per second, with the reference's CLI for the flags this slice supports
plus ``--device``.  The weights come from a seeded generator and the
batch from another, made on the device.

Run:  python -m horovod_tpu_torch.examples.synthetic_benchmark --batch-size 128
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import core
from ..models import MODELS
from ..ops.compression import Compression
from ..optim.fused_update import fused_sgd
from ..training import init_train_state, make_train_step, shard_batch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="horovod_tpu_torch Synthetic Benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--fp16-allreduce", action="store_true", default=False,
                        help="use bf16 compression during allreduce")
    parser.add_argument("--model", type=str, default="ResNet50",
                        choices=sorted(MODELS), help="model to benchmark")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="input batch size per rank")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--num-warmup-batches", type=int, default=10,
                        help="number of warm-up batches not benchmarked")
    parser.add_argument("--num-batches-per-iter", type=int, default=10,
                        help="number of batches per benchmark iteration")
    parser.add_argument("--num-in-graph-steps", type=int, default=1,
                        help="optimizer steps per call of the step")
    parser.add_argument("--num-iters", type=int, default=10,
                        help="number of benchmark iterations")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(_DTYPES),
                        help="model compute dtype (params stay float32)")
    parser.add_argument("--fused-optimizer", action="store_true",
                        default=False,
                        help="flat fused update kernel instead of the "
                             "per-leaf traversal (same math)")
    parser.add_argument("--loss-fetch-steps", type=int, default=None,
                        help="trailing loss-fetch cadence "
                             "(default: the HVD_LOSS_FETCH_STEPS knob)")
    for option in ("norm-act", "residual-join", "conv-bn"):
        parser.add_argument(f"--{option}", type=str, default="xla",
                            choices=["xla", "pallas"],
                            help=f"ResNet {option.replace('-', '_')}: "
                                 "'pallas' runs the hand-written kernel "
                                 "variant (same math)")
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' to run on the CPU; default: this "
                             "rank's CUDA device")
    return parser.parse_args(argv)


def log(s):
    if core.rank() == 0:
        print(s, flush=True)


def run(args) -> dict:
    core.init(device=args.device)
    device = core.device()
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True

    model = MODELS[args.model](
        num_classes=args.num_classes, dtype=_DTYPES[args.dtype],
        norm_act=args.norm_act,
        residual_join=args.residual_join, conv_bn=args.conv_bn,
        generator=torch.Generator().manual_seed(0),
    ).to(device, memory_format=torch.channels_last)
    opt = fused_sgd(0.01, momentum=0.9)

    global_batch = args.batch_size * core.size()
    gen = torch.Generator(device=device).manual_seed(42)
    data = torch.rand((global_batch, args.image_size, args.image_size, 3),
                      generator=gen, device=device)
    target = torch.randint(0, args.num_classes, (global_batch,),
                           generator=gen, device=device)

    step = make_train_step(
        apply_fn=model,
        loss_fn=F.cross_entropy,
        optimizer=opt,
        op=core.Average,
        compression=Compression.fp16 if args.fp16_allreduce else None,
        has_batch_stats=True,
        in_graph_steps=args.num_in_graph_steps,
        fused_optimizer=args.fused_optimizer,
        loss_fetch_steps=args.loss_fetch_steps,
    )
    state = init_train_state(model, opt, has_batch_stats=True)
    x = shard_batch(data)
    y = shard_batch(target)

    log(f"Model: {args.model}")
    log(f"Batch size: {args.batch_size} (global {global_batch})")
    log(f"Number of devices: {core.size()} ({device})")

    # Reading the loss waits for the whole chain of steps queued before it.
    log("Running warmup...")
    for _ in range(max(args.num_warmup_batches, 1)):
        state, loss = step(state, x, y)
    loss.item()

    log("Running benchmark...")
    imgs_per_call = (args.batch_size * core.size()
                     * max(args.num_in_graph_steps, 1))
    img_secs = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            state, loss = step(state, x, y)
        loss.item()
        dt = time.perf_counter() - t0
        img_sec = imgs_per_call * args.num_batches_per_iter / dt
        log(f"Iter: Img/sec total: {img_sec:.1f}")
        img_secs.append(img_sec)

    img_sec_mean = float(np.mean(img_secs))
    img_sec_conf = float(1.96 * np.std(img_secs))
    log(f"Img/sec per device: {img_sec_mean / core.size():.1f}")
    log(f"Total img/sec on {core.size()} device(s): "
        f"{img_sec_mean:.1f} +-{img_sec_conf:.1f}")
    return {
        "img_sec_total": img_sec_mean,
        "img_sec_per_chip": img_sec_mean / core.size(),
        "conf": img_sec_conf,
        "size": core.size(),
        "final_loss": float(loss.item()),
    }


if __name__ == "__main__":
    run(parse_args())
