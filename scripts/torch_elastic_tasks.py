#!/usr/bin/env python3
"""Worker tasks of the port's fault-tolerance path, each run by
``python -m horovod_tpu_torch.run`` (``chip_smoke.py``'s phase
``elastic`` starts them; so can a user):

    python -m horovod_tpu_torch.run -np 1 --restarts 1 \\
        python3 scripts/torch_elastic_tasks.py restart --ckpt DIR --steps 16
    python -m horovod_tpu_torch.run -np 2 --controller native \\
        python3 scripts/torch_elastic_tasks.py allreduce --elements 25557032

``restart`` trains the headline cell — ResNet-50, 224x224, batch 128,
bf16 over float32 parameters, fused momentum (K1), graphed — under
:class:`~horovod_tpu_torch.ElasticState`: it resumes from the newest
committed checkpoint in ``--ckpt``, saves one every ``--save-every``
steps (rank 0 writes ``step_N``), and gives step ``s`` the batch made on
the device from seed ``1000 + s``, so a resumed run sees the batches an
unbroken one sees.  cuDNN runs its deterministic algorithms.  A fault
(``HVD_FAULT_SPEC``) can end the process at any step; the launcher's
``--restarts`` then starts it again.  ``--device cpu`` with a small
``--image-size`` / ``--batch-size`` runs it on the CPU.

``allreduce`` joins the world on the CPU (``init(device="cpu")``: the
controller and the ring are host planes) and sums a float32 array of
``--elements`` values, made on each rank from its rank as the seed,
``--reps`` times with ``process_allreduce``: over the peer ring under
the native controller, or over the coordinator star with ``HVD_RING=0``;
then ``--star-reps`` times over the star (the controller's
``allreduce_data``, the path ``process_allreduce`` takes without the
ring).  It checks each result against numpy's sum of every rank's
array.

Each prints one JSON line an event on its standard output (the launcher
prefixes the rank).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def batch(step: int, batch_size: int, image_size: int, classes: int,
          device) -> tuple:
    """Step ``step``'s batch, made on ``device`` from seed 1000 + step."""
    gen = torch.Generator(device=device).manual_seed(1000 + step)
    x = torch.rand((batch_size, image_size, image_size, 3), generator=gen,
                   device=device)
    y = torch.randint(0, classes, (batch_size,), generator=gen,
                      device=device)
    return x, y


def train(ckpt: str, steps: int, *, save_every: int = 5,
          device: str = "cuda", image_size: int = 224,
          batch_size: int = 128, classes: int = 1000,
          out=emit, shutdown: bool = True) -> list:
    """The ``restart`` task in this process: ``(step, loss)`` of every
    step it ran (see the module docstring).  ``shutdown=False`` leaves
    the world up (a caller that had initialized it)."""
    import torch.nn.functional as F

    import horovod_tpu_torch as htt
    from horovod_tpu_torch.models import ResNet50

    htt.init(device=device)
    dev = htt.device()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    with torch.device(dev):
        model = ResNet50(num_classes=classes, dtype=dtype,
                         generator=torch.Generator(device=dev).manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    opt = htt.fused_sgd(0.01, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, has_batch_stats=True,
                               fused_optimizer=True, loss_fetch_steps=0)
    state = htt.init_train_state(model, opt, has_batch_stats=True)
    es = htt.ElasticState(ckpt, state)
    t0 = time.time()
    state, start = es.resume()
    out(event="resume", step=start, restart=es.restart_count,
        seconds=time.time() - t0, t=time.time())
    losses = []
    for s in range(start, steps):
        x, y = batch(s, batch_size, image_size, classes, dev)
        out(event="call", step=s, t=time.time())
        state, loss = step(state, x, y)
        value = loss.item()
        losses.append((s, value))
        out(event="step", step=s, loss=float.hex(value), t=time.time(),
            calls=dict(step.calls))
        if (s + 1) % save_every == 0:
            es.state = state
            es.save(s + 1)
            out(event="save", step=s + 1, t=time.time())
    if shutdown:
        htt.shutdown()
    return losses


def allreduce(elements: int, reps: int, star_reps: int = 0) -> None:
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.runtime import eager_controller

    htt.init(device="cpu")
    rank, size = htt.rank(), htt.size()
    arrays = [np.random.default_rng(r).standard_normal(elements,
                                                       dtype=np.float32)
              for r in range(size)]
    want = arrays[0].copy()
    for a in arrays[1:]:
        want += a
    ring = "ring" if eager_controller.ring() is not None else "star"
    star = eager_controller.client()
    runs = [(ring, i) for i in range(reps)] + \
        [("star", i) for i in range(star_reps)]
    for transport, i in runs:
        name = f"bench.{transport}.{i}"
        t0 = time.perf_counter()
        if transport == ring:
            got = htt.eager.process_allreduce(arrays[rank], op=htt.Sum,
                                              name=name)
        else:
            got = star.allreduce_data(name, arrays[rank])
        dt = time.perf_counter() - t0
        if not np.array_equal(got, want):
            raise SystemExit(f"{transport} allreduce {i}: the sum differs "
                             f"from numpy's at {int((got != want).sum())} "
                             "elements")
        emit(event="allreduce", transport=transport, rank=rank, size=size,
             rep=i, bytes=int(arrays[rank].nbytes), seconds=dt,
             gb_per_s=arrays[rank].nbytes / dt / 1e9)
    htt.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="task", required=True)
    r = sub.add_parser("restart")
    r.add_argument("--ckpt", required=True)
    r.add_argument("--steps", type=int, default=16)
    r.add_argument("--save-every", type=int, default=5)
    r.add_argument("--device", default="cuda")
    r.add_argument("--image-size", type=int, default=224)
    r.add_argument("--batch-size", type=int, default=128)
    r.add_argument("--num-classes", type=int, default=1000)
    a = sub.add_parser("allreduce")
    a.add_argument("--elements", type=int, default=25_557_032)
    a.add_argument("--reps", type=int, default=3)
    a.add_argument("--star-reps", type=int, default=0)
    args = ap.parse_args()
    if args.task == "restart":
        train(args.ckpt, args.steps, save_every=args.save_every,
              device=args.device, image_size=args.image_size,
              batch_size=args.batch_size, classes=args.num_classes)
    else:
        allreduce(args.elements, args.reps, args.star_reps)


if __name__ == "__main__":
    main()
