#!/usr/bin/env python3
"""Worker tasks of the port's serving plane and watchdog, each run by
``python -m horovod_tpu_torch.run`` (``chip_smoke.py``'s phase
``serving`` starts them; so can a user):

    HVD_SERVE_WEIGHT_COMPRESSION=int8 python -m horovod_tpu_torch.run \\
        -np 1 --serve --serve-max-batch 1 python3 \\
        scripts/torch_serve_tasks.py serve --ckpt DIR --port-file F \\
        --done-file D
    HVD_FAULT_SPEC="rank=0:step=40:kind=slow=30ms;..." \\
        python -m horovod_tpu_torch.run -np 1 python3 \\
        scripts/torch_serve_tasks.py watch --steps 300

``serve`` is a remote replica: it builds the served model — ResNet-50
with the three kernel options set to pallas (K6, K7, K8), bf16 compute
over float32 parameters, channels-last, in eval mode — restores its
weights from the checkpoint in ``--ckpt`` (``load_params``), and runs
``serve_worker_loop`` on the card against the launcher's broker over
``RemoteSource`` (the launcher's ``HVD_SERVE_*`` knobs set its batcher,
``HVD_SERVE_WEIGHT_COMPRESSION`` its weights at rest), every bucket's
graph captured first.  It writes the rendezvous server's address to
``--port-file`` once its graphs are captured, and stops when
``--done-file`` appears.

``watch`` trains the headline cell — ResNet-50, 224x224, batch 128, bf16
over float32 parameters, fused momentum (K1), graphed — reading each
step's loss (so the step cadence is each step's own time), with the
launcher's watchdog on (its default) and the step's dormant profiler.
Every 10 steps from step ``--poll-from`` on it reads ``GET /alerts`` and
``GET /profile`` from the launcher's server; it stops once a
``step_time_regression`` alert has come and the armed window's anatomy
has reached ``/profile``, or after ``--steps``.  A poll's HTTP calls
fall inside the next step's cadence (dispatch to dispatch), a spike the
step-time detector can read as a regression, so a caller that slows the
job from some step on polls from that step.  The last event carries the
cadence the launcher holds (``cadence_ms``).  cuDNN runs its
deterministic algorithms in both.
``--device cpu`` (with a small ``--image-size`` / ``--batch-size`` for
``watch``) runs either on the CPU.

Each prints one JSON line an event on its standard output (the launcher
prefixes the rank).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the three kernel options of the served model (chip_smoke's VARIANTS)
VARIANTS = {"norm_act": "pallas", "residual_join": "pallas",
            "conv_bn": "pallas"}
IMAGE = (224, 224, 3)


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def deterministic() -> None:
    """cuDNN's deterministic algorithms, no benchmark, TF32 off."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def served_model(device="cuda", seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
    """The served ResNet-50 (module docstring) on ``device``, initialized
    from a generator there seeded with ``seed``, in eval mode."""
    from horovod_tpu_torch.models import ResNet50

    device = torch.device(device)
    with torch.device(device):
        model = ResNet50(dtype=dtype, **VARIANTS,
                         generator=torch.Generator(
                             device=device).manual_seed(seed))
    return model.to(memory_format=torch.channels_last).eval()


def serve(ckpt: str, port_file: str, done_file: str,
          device: str = "cuda") -> None:
    from horovod_tpu_torch.serving import (
        load_params,
        module_apply_fn,
        serve_worker_loop,
    )
    from horovod_tpu_torch.utils import env as env_util

    deterministic()
    apply_fn, like = module_apply_fn(served_model(device, seed=1))
    params = load_params(ckpt, like)
    stop = threading.Event()

    def ready():  # the graphs are captured: requests may come
        Path(port_file).write_text(json.dumps({
            "addr": os.environ[env_util.HVD_METRICS_KV_ADDR],
            "port": int(os.environ[env_util.HVD_METRICS_KV_PORT])}))
        threading.Thread(target=watch_done, daemon=True).start()

    def watch_done():
        while not os.path.exists(done_file):
            time.sleep(0.05)
        stop.set()

    t0 = time.time()
    serve_worker_loop(apply_fn, params, stop_event=stop, poll_s=0.1,
                      device=device, on_ready=ready,
                      warmup_sample=np.zeros(IMAGE, np.float32))
    emit(event="served", seconds=time.time() - t0)


def early_fires(cadence, slow_from: int) -> list:
    """The steps at which the launcher's step-time detector, with the
    watchdog's knobs, fires on some prefix of ``cadence`` (``[[step,
    seconds], ...]``) that ends at or before ``slow_from``: the ticks that
    could have raised an alert before the job was slowed."""
    from horovod_tpu_torch.observe import detectors
    from horovod_tpu_torch.observe.watchdog import Watchdog

    wd = Watchdog(server=None)
    clean = [(s, v) for s, v in cadence if s <= slow_from]
    fired = set()
    for n in range(1, len(clean) + 1):
        alert = detectors.ewma_mad_regression(
            clean[:n][-wd.window:], alpha=wd.alpha, k=wd.mad_k,
            warmup=max(8, min(n - wd.confirm, wd.window // 2)),
            confirm=wd.confirm)
        if alert:
            fired.add(alert["evidence"]["fired_step"])
    return sorted(fired)


def watch(steps: int, poll_every: int = 10, poll_from: int = 1,
          device: str = "cuda", image_size: int = 224,
          batch_size: int = 128) -> None:
    import torch.nn.functional as F

    import horovod_tpu_torch as htt
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.run import http_client
    from horovod_tpu_torch.utils import env as env_util

    htt.init(device=device)
    dev = htt.device()
    deterministic()
    with torch.device(dev):
        model = ResNet50(generator=torch.Generator(device=dev).manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    opt = htt.fused_sgd(0.01, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, has_batch_stats=True,
                               fused_optimizer=True, loss_fetch_steps=0)
    state = htt.init_train_state(model, opt, has_batch_stats=True)
    gen = torch.Generator(device=dev).manual_seed(1000)
    x = torch.rand((batch_size, image_size, image_size, 3), generator=gen,
                   device=dev)
    y = torch.randint(0, 1000, (batch_size,), generator=gen, device=dev)
    addr = os.environ[env_util.HVD_METRICS_KV_ADDR]
    port = int(os.environ[env_util.HVD_METRICS_KV_PORT])
    secret = bytes.fromhex(os.environ[env_util.HVD_METRICS_SECRET])
    prof = step.profiler
    emit(event="start", dormant=prof is not None and not prof.enabled,
         t=time.time())
    alert = profile = None
    times, lag, series = [], [], {}
    for s in range(1, steps + 1):
        t = time.perf_counter()
        state, loss = step(state, x, y)
        loss.item()
        times.append(time.perf_counter() - t)
        if s % poll_every or s < poll_from:
            continue
        # the newest step of this rank the launcher holds: how far the
        # watchdog's input trails the job
        doc = (http_client.get_timeseries(addr, port, secret=secret)
               .get("ranks") or {}).get("0") or {}
        series = ((doc.get("series") or {}).get("step_seconds") or {})
        lag.append([s, ((series.get("samples") or [[None]])[-1])[0]])
        alerts = http_client.get_alerts(addr, port, secret=secret)
        alert = next((a for a in alerts.get("alerts", ())
                      if a.get("signal") == "step_time_regression"), None)
        profile = http_client.get_profile(addr, port, secret=secret)
        if alert is not None and (profile or {}).get("ranks"):
            break
    emit(event="watched", steps=s, alert=alert, profile=profile,
         armed_window=[prof.start_step, prof.end_step] if prof else None,
         profiler_enabled=bool(prof and prof.enabled),
         anatomy_steps=(prof.anatomy or {}).get("steps") if prof else None,
         step_ms=[round(v * 1e3, 3) for v in times],
         cadence_ms=[[st, round(v * 1e3, 3)]
                     for st, v in series.get("samples") or ()],
         launcher_newest_step=lag,
         calls=dict(step.calls))
    htt.shutdown()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="task", required=True)
    s = sub.add_parser("serve")
    s.add_argument("--ckpt", required=True)
    s.add_argument("--port-file", required=True)
    s.add_argument("--done-file", required=True)
    w = sub.add_parser("watch")
    w.add_argument("--steps", type=int, default=300)
    w.add_argument("--image-size", type=int, default=224)
    w.add_argument("--batch-size", type=int, default=128)
    w.add_argument("--poll-from", type=int, default=1)
    for sp in (s, w):
        sp.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.task == "serve":
        serve(args.ckpt, args.port_file, args.done_file, args.device)
    else:
        watch(args.steps, poll_from=args.poll_from, device=args.device,
              image_size=args.image_size, batch_size=args.batch_size)


if __name__ == "__main__":
    main()
