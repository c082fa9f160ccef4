"""ResNet-50 ImageNet training through the Horovod torch frontend: the
port of ``examples/pytorch_imagenet_resnet50.py`` (itself the reference's
full torch recipe), on ``horovod_tpu_torch.torch``.

What the recipe shows, each on the port's form:

* resume: rank 0 looks for the newest checkpoint, ``broadcast_object``
  agrees on the epoch, and rank 0 alone reads the file (the broadcasts
  below ship its state to the others);
* ``DistributedOptimizer(named_parameters, compression,
  backward_passes_per_step)`` with optional bf16 wire compression
  (``--fp16-allreduce``, the reference's alias) and gradient
  accumulation (``--batches-per-allreduce``);
* rank 0's parameters and optimizer state broadcast to every rank;
* the learning-rate warm-up and staircase schedule by epoch;
* validation accuracy averaged across ranks with ``allreduce``;
* checkpoints written by rank 0 only (``torch.save`` of the model's and
  the optimizer's state dicts).

The model is the plain-torch ResNet-50 of
``pytorch_synthetic_benchmark.py`` (no torchvision); the data is
synthetic, made from a seed on each rank.  Two things differ from the
reference's script: ``--batch-size`` must divide by
``--batches-per-allreduce`` (the reference would step its optimizer a
different number of times than ``backward_passes_per_step`` says and
apply partly accumulated gradients), and the loss an epoch reports is
the mean cross-entropy of its last batch (the reference reports the last
micro-batch's loss divided by ``--batches-per-allreduce``).

Run:  python -m horovod_tpu_torch.run -np 2 python -m \\
          horovod_tpu_torch.examples.pytorch_imagenet_resnet50 \\
          --epochs 1 --steps-per-epoch 4
(``--device cpu --image-size 64`` for a small run on the CPU.)
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import core
from horovod_tpu_torch.examples.pytorch_synthetic_benchmark import _resnet


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="horovod_tpu_torch torch ImageNet recipe",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--checkpoint-format",
                   default="./checkpoint-{epoch}.pt",
                   help="rank-0 checkpoint path pattern")
    p.add_argument("--fp16-allreduce", action="store_true",
                   help="bf16 wire compression for gradient allreduce")
    p.add_argument("--batches-per-allreduce", type=int, default=1,
                   help="accumulate N backwards before communicating "
                        "(backward_passes_per_step)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--steps-per-epoch", type=int, default=8,
                   help="steps per epoch (synthetic data)")
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--warmup-epochs", type=float, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=0.00005)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU; default: this rank's "
                        "CUDA device")
    args = p.parse_args(argv)
    if args.batches_per_allreduce < 1 or \
            args.batch_size % args.batches_per_allreduce:
        p.error(f"--batch-size {args.batch_size} must divide by "
                f"--batches-per-allreduce {args.batches_per_allreduce}")
    return args


def adjust_lr(optimizer, args, epoch: int, step: int, spe: int) -> float:
    """The reference's adjust_learning_rate: a linear warm-up over the
    first warmup_epochs to base_lr × size, then /10 at epochs 30, 60
    and 80."""
    if epoch < args.warmup_epochs:
        frac = (epoch * spe + step + 1) / (args.warmup_epochs * spe)
        lr = args.base_lr * (frac * (hvd.size() - 1) + 1)
    else:
        decay = 10 ** -sum(epoch >= e for e in (30, 60, 80))
        lr = args.base_lr * hvd.size() * decay
    for group in optimizer.param_groups:
        group["lr"] = lr
    return lr


def metric_average(val: float, name: str) -> float:
    return float(hvd.allreduce(torch.tensor([val]), name=name)[0])


def run(args) -> dict:
    hvd.init(device=args.device)
    device = core.device()
    torch.manual_seed(42 + hvd.rank())
    verbose = hvd.rank() == 0

    model = _resnet([3, 4, 6, 3], args.num_classes, True).to(device)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.base_lr,
                                momentum=args.momentum,
                                weight_decay=args.wd)

    # resume: rank 0 finds the newest checkpoint, everyone agrees
    resume = 0
    if verbose:
        for e in range(args.epochs, 0, -1):
            if os.path.exists(args.checkpoint_format.format(epoch=e)):
                resume = e
                break
    resume = hvd.broadcast_object(resume, root_rank=0,
                                  name="resume_from_epoch")
    if resume > 0 and verbose:
        ckpt = torch.load(args.checkpoint_format.format(epoch=resume),
                          map_location=device, weights_only=True)
        model.load_state_dict(ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=(hvd.Compression.fp16 if args.fp16_allreduce
                     else hvd.Compression.none),
        backward_passes_per_step=args.batches_per_allreduce)

    spe = args.steps_per_epoch
    gen = torch.Generator(device=device).manual_seed(7 + hvd.rank())
    micro = args.batch_size // args.batches_per_allreduce
    last = {"loss": float("nan"), "acc": 0.0}
    for epoch in range(resume, args.epochs):
        model.train()
        for step in range(spe):
            lr = adjust_lr(optimizer, args, epoch, step, spe)
            bx = torch.randn((args.batch_size, 3, args.image_size,
                              args.image_size), generator=gen, device=device)
            by = torch.randint(0, args.num_classes, (args.batch_size,),
                               generator=gen, device=device)
            # the frontend's contract: step() after every backward; it
            # synchronizes and applies on the Nth.  Each micro loss is
            # divided by N, so the accumulated gradient is the mean
            optimizer.zero_grad()
            batch_loss = 0.0
            for lo in range(0, args.batch_size, micro):
                loss = F.cross_entropy(model(bx[lo:lo + micro]),
                                       by[lo:lo + micro])
                (loss / args.batches_per_allreduce).backward()
                optimizer.step()
                batch_loss += loss.item() / args.batches_per_allreduce

        # cross-rank averaged epoch metrics (the reference's
        # metric_average)
        model.eval()
        with torch.no_grad():
            acc = float((model(bx).argmax(1) == by).float().mean())
        last = {"loss": metric_average(batch_loss, "avg_loss"),
                "acc": metric_average(acc, "avg_accuracy"), "lr": lr}
        if verbose:
            print(f"epoch {epoch}: loss {last['loss']:.4f} "
                  f"acc {last['acc']:.3f} lr {lr:.5f}", flush=True)
            torch.save({"model": model.state_dict(),
                        "optimizer": optimizer.state_dict()},
                       args.checkpoint_format.format(epoch=epoch + 1))
    return {"last_loss": last["loss"], "accuracy": last["acc"],
            "epochs_run": args.epochs - resume}


if __name__ == "__main__":
    run(parse_args())
