"""PyTorch synthetic benchmark through the Horovod torch frontend: the
port of ``examples/pytorch_synthetic_benchmark.py``.

The reference harness at its defaults (ResNet-50, batch 32, 224×224,
float32): ``init`` → the model → ``torch.optim.SGD(lr=0.01·size,
momentum=0.9)`` wrapped in ``DistributedOptimizer`` with its named
parameters and, with ``--fp16-allreduce``, bf16 compression (the
reference's alias) → the parameters and optimizer state broadcast from
rank 0 → timed iterations, reporting images per second per process.
The models are the reference's own plain-torch ResNets (kept here as a
copy; the reference has no torchvision), seeded with
``torch.manual_seed(42)`` as there, and so is the batch.

The step is eager, as the reference's frontend is: the gradients are
all-reduced by the optimizer's hooks as the backward makes them, one
``all_reduce`` a parameter.  Each timed iteration ends by reading its
last loss (the reference reads every step's; reading once keeps the
host from waiting for the card inside an iteration).  ``--device cpu``
runs it on the CPU.

Run:  python -m horovod_tpu_torch.examples.pytorch_synthetic_benchmark
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="horovod_tpu_torch PyTorch Synthetic Benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--model", type=str, default="resnet50",
                        choices=["smallconv", "resnet18", "resnet50"])
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--fp16-allreduce", action="store_true",
                        default=False)
    parser.add_argument("--num-warmup-batches", type=int, default=2)
    parser.add_argument("--num-batches-per-iter", type=int, default=3)
    parser.add_argument("--num-iters", type=int, default=3)
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' to run on the CPU; default: this "
                             "rank's CUDA device")
    return parser.parse_args(argv)


def _resnet(layers, num_classes: int, bottleneck: bool, width: int = 64):
    """The reference's plain-torch ResNet (He et al. v1.5 layout);
    ``width`` is the stem's channels (64, the reference's), which a
    narrow copy for parity checks reduces."""

    class BasicBlock(nn.Module):
        expansion = 1

        def __init__(self, cin, planes, stride=1):
            super().__init__()
            self.c1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
            self.b1 = nn.BatchNorm2d(planes)
            self.c2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
            self.b2 = nn.BatchNorm2d(planes)
            cout = planes * self.expansion
            self.proj = (
                nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                              nn.BatchNorm2d(cout))
                if (stride != 1 or cin != cout) else nn.Identity())
            self.relu = nn.ReLU(inplace=True)

        def forward(self, x):
            y = self.relu(self.b1(self.c1(x)))
            y = self.b2(self.c2(y))
            return self.relu(y + self.proj(x))

    class Bottleneck(nn.Module):
        expansion = 4

        def __init__(self, cin, planes, stride=1):
            super().__init__()
            cout = planes * self.expansion
            self.c1 = nn.Conv2d(cin, planes, 1, bias=False)
            self.b1 = nn.BatchNorm2d(planes)
            self.c2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
            self.b2 = nn.BatchNorm2d(planes)
            self.c3 = nn.Conv2d(planes, cout, 1, bias=False)
            self.b3 = nn.BatchNorm2d(cout)
            self.proj = (
                nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                              nn.BatchNorm2d(cout))
                if (stride != 1 or cin != cout) else nn.Identity())
            self.relu = nn.ReLU(inplace=True)

        def forward(self, x):
            y = self.relu(self.b1(self.c1(x)))
            y = self.relu(self.b2(self.c2(y)))
            y = self.b3(self.c3(y))
            return self.relu(y + self.proj(x))

    block = Bottleneck if bottleneck else BasicBlock
    stages = []
    cin = width
    for i, n in enumerate(layers):
        planes = width * 2 ** i
        for j in range(n):
            stages.append(block(cin, planes, 2 if i > 0 and j == 0 else 1))
            cin = planes * block.expansion
    return nn.Sequential(
        nn.Conv2d(3, width, 7, 2, 3, bias=False), nn.BatchNorm2d(width),
        nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, 1),
        *stages,
        nn.AdaptiveAvgPool2d(1), nn.Flatten(),
        nn.Linear(cin, num_classes))


def make_model(name: str, num_classes: int, width: int = 64) -> nn.Module:
    """The reference's ``_make_model``: smallconv, resnet18 or resnet50."""
    if name == "smallconv":
        return nn.Sequential(
            nn.Conv2d(3, 16, 3, padding=1), nn.ReLU(),
            nn.MaxPool2d(2),
            nn.Conv2d(16, 32, 3, padding=1), nn.ReLU(),
            nn.AdaptiveAvgPool2d(1), nn.Flatten(),
            nn.Linear(32, num_classes))
    if name == "resnet18":
        return _resnet([2, 2, 2, 2], num_classes, False, width)
    return _resnet([3, 4, 6, 3], num_classes, True, width)


def run(args, then: Optional[Callable] = None) -> dict:
    """The benchmark.  ``then(step)``, when given, is called after the
    timed window with the function that runs one step (``chip_smoke.py``
    traces more steps with it); what it returns is the result's
    ``"then"``."""
    hvd.init(device=args.device)
    device = hvd.core.device()
    torch.manual_seed(42)

    model = make_model(args.model, args.num_classes).to(device)
    opt = torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                          momentum=0.9)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters(),
        compression=hvd.Compression.fp16 if args.fp16_allreduce
        else hvd.Compression.none)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    data = torch.randn(args.batch_size, 3, args.image_size,
                       args.image_size).to(device)
    target = torch.randint(0, args.num_classes, (args.batch_size,)).to(
        device)

    def benchmark_step():
        opt.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        opt.step()
        return loss.detach()

    def log(s):
        if hvd.rank() == 0:
            print(s, flush=True)

    log(f"Model: {args.model}  batch {args.batch_size}  procs {hvd.size()}"
        f"  device {device}")
    for _ in range(args.num_warmup_batches):
        loss = benchmark_step()
    loss.item()

    img_secs = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = benchmark_step()
        loss.item()
        dt = time.perf_counter() - t0
        img_sec = args.batch_size * args.num_batches_per_iter / dt
        log(f"Iter: img/sec per proc: {img_sec:.1f}")
        img_secs.append(img_sec)

    final_loss = float(loss.item())
    after = then(benchmark_step) if then is not None else None
    mean = float(np.mean(img_secs))
    log(f"Img/sec per proc: {mean:.1f}")
    return {"img_sec_per_proc": mean, "final_loss": final_loss,
            **({"then": after} if then is not None else {})}


if __name__ == "__main__":
    run(parse_args())
