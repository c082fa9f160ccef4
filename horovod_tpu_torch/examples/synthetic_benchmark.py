"""Synthetic benchmark: the port of ``examples/synthetic_benchmark.py``.

Trains a model of the image registry (``models.MODELS``: the ResNets,
VGG, Inception V3, the ViTs) data-parallel on one synthetic batch and
reports images per second, with the reference's CLI for the flags this
slice supports (``--compression``, ``--adasum`` and ``--hierarchical``
among them) plus ``--device``.  As in the reference,
``--fused-optimizer`` trains with ``fused_sgd(0.01, momentum=0.9)``, the
flat kernel K1, and without it with ``sgd(0.01, momentum=0.9)`` (optax's,
``optim/transforms.py``) leaf by leaf; the ResNet kernel options
(``--norm-act``, ``--residual-join``, ``--conv-bn``) go to the ResNets
only, and raise for any other model.  The weights come from a seeded
generator and the batch from another, both on the device (initializing
VGG-16's 138M parameters on the card takes a fraction of the CPU's
time).  On a card the step is the compiled one: the first warm-up call
runs eagerly, the second captures ``--num-in-graph-steps`` steps into a
CUDA graph, and the rest replay it, so with two or more warm-up batches
the timed window holds only replays.

Run:  python -m horovod_tpu_torch.examples.synthetic_benchmark --batch-size 128
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import core
from ..models import BATCH_STATS_FREE, MODELS
from ..ops.compression import Compression, ErrorFeedback
from ..ops.compression import from_env as compression_from_env
from ..optim.fused_update import fused_sgd
from ..optim.transforms import sgd
from ..training import init_train_state, make_train_step, shard_batch
from ..utils import env as env_util

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="horovod_tpu_torch Synthetic Benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--fp16-allreduce", action="store_true", default=False,
                        help="use bf16 compression during allreduce")
    parser.add_argument("--compression", type=str, default=None,
                        choices=["none", "bf16", "fp16", "int8", "fp8",
                                 "fp8_e5m2"],
                        help="gradient wire format (quantized formats "
                             "carry the error-feedback residual; "
                             "default: the HVD_COMPRESSION env knob)")
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
    parser.add_argument("--adasum", action="store_true", default=False,
                        help="use Adasum reduction")
    parser.add_argument("--hierarchical", action="store_true", default=False,
                        help="use the two-level (local / cross) allreduce")
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


#: the ResNet kernel options and their flags
RESNET_OPTIONS = ("norm_act", "residual_join", "conv_bn")


def build_model(args, device) -> torch.nn.Module:
    """The registry's model at ``args``' size, initialized on ``device``
    from a generator there seeded with 0: the kernel options to a ResNet,
    the image size to the others (it sizes VGG's first Dense and ViT's
    position table; Inception checks it)."""
    kw = {"num_classes": args.num_classes, "dtype": _DTYPES[args.dtype],
          "generator": torch.Generator(device=device).manual_seed(0)}
    options = {o: getattr(args, o) for o in RESNET_OPTIONS}
    if args.model.startswith("ResNet"):
        kw.update(options)
    else:
        set_options = [o for o, v in options.items() if v != "xla"]
        if set_options:
            raise ValueError(
                f"--{set_options[0].replace('_', '-')} is a ResNet option; "
                f"{args.model} has no such layer")
        kw["image_size"] = args.image_size
    with torch.device(device):
        return MODELS[args.model](**kw)


def log(s):
    if core.rank() == 0:
        print(s, flush=True)


def run(args, eager: bool = False,
        then: Optional[Callable] = None) -> dict:
    """The benchmark; ``eager`` times ``step.eager``, the same step never
    captured, instead of the step (to compare the two).  ``then(step,
    state, x, y)``, when given, is called after the timed window with the
    step that was timed, its state and its inputs (``chip_smoke.py``
    traces more calls with it); what it returns is the result's
    ``"then"``."""
    core.init(device=args.device)
    device = core.device()
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True

    model = build_model(args, device).to(memory_format=torch.channels_last)
    has_batch_stats = args.model not in BATCH_STATS_FREE
    opt = fused_sgd(0.01, momentum=0.9) if args.fused_optimizer \
        else sgd(0.01, momentum=0.9)

    global_batch = args.batch_size * core.size()
    gen = torch.Generator(device=device).manual_seed(42)
    data = torch.rand((global_batch, args.image_size, args.image_size, 3),
                      generator=gen, device=device)
    target = torch.randint(0, args.num_classes, (global_batch,),
                           generator=gen, device=device)

    if args.compression:
        compression = Compression.lookup(
            args.compression, error_feedback=env_util.get_bool(
                env_util.HVD_COMPRESSION_ERROR_FEEDBACK, True))
    elif args.fp16_allreduce:
        compression = Compression.fp16
    else:
        compression = None  # make_train_step reads HVD_COMPRESSION
    step = make_train_step(
        apply_fn=model,
        loss_fn=F.cross_entropy,
        optimizer=opt,
        op=core.Adasum if args.adasum else core.Average,
        compression=compression,
        has_batch_stats=has_batch_stats,
        hierarchical=args.hierarchical,
        in_graph_steps=args.num_in_graph_steps,
        fused_optimizer=args.fused_optimizer,
        loss_fetch_steps=args.loss_fetch_steps,
    )
    effective = compression if compression is not None \
        else compression_from_env()
    state = init_train_state(
        model, opt, has_batch_stats=has_batch_stats,
        compression=effective if isinstance(effective, ErrorFeedback)
        else None)
    run_step = step.eager if eager else step
    x = shard_batch(data)
    y = shard_batch(target)

    log(f"Model: {args.model}")
    log(f"Batch size: {args.batch_size} (global {global_batch})")
    log(f"Number of devices: {core.size()} ({device})")

    # Reading the loss waits for the whole chain of steps queued before it.
    log("Running warmup...")
    for _ in range(max(args.num_warmup_batches, 1)):
        state, loss = run_step(state, x, y)
    loss.item()

    log("Running benchmark...")
    imgs_per_call = (args.batch_size * core.size()
                     * max(args.num_in_graph_steps, 1))
    img_secs = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            state, loss = run_step(state, x, y)
        loss.item()
        dt = time.perf_counter() - t0
        img_sec = imgs_per_call * args.num_batches_per_iter / dt
        log(f"Iter: Img/sec total: {img_sec:.1f}")
        img_secs.append(img_sec)

    calls, final_loss = dict(step.calls), float(loss.item())
    after = then(run_step, state, x, y) if then is not None else None
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
        "final_loss": final_loss,
        "step_calls": calls,
        **({"then": after} if then is not None else {}),
    }


if __name__ == "__main__":
    run(parse_args())
