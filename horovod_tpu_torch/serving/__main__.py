"""``python -m horovod_tpu_torch.serving`` — serve a trained checkpoint
behind the continuous-batching serving plane, or self-test / bench the
plane itself: the port of ``scripts/hvd_serve.py``.

Modes:

    python -m horovod_tpu_torch.serving --check
        Fixture self-test: deterministic batcher flush pins,
        autoscale-policy hysteresis pins, and a live in-process replica
        fleet under a seeded bursty open-loop trace with zero-drop
        accounting.  The fleet serves the eager MLP on the CPU unless
        ``--device`` names the card.  Exit 0/1.

    python -m horovod_tpu_torch.serving --bench [--json]
        The bench fixture on its own: the seeded bursty trace against a
        small MLP fleet, one CUDA graph a bucket on the card; prints
        serve_p50_ms / serve_p99_ms / goodput_under_burst.

    python -m horovod_tpu_torch.serving --checkpoint DIR --model mlp \\
            [--replicas N] [--port P] [--secret HEX]
        Stand up a local serving stack: rendezvous server with the
        signed POST /infer + GET /serving routes, N in-process replica
        threads over the restored weights on the card.  Ctrl-C stops it.

    python -m horovod_tpu_torch.serving --worker --checkpoint DIR --model mlp
        Remote replica under ``python -m horovod_tpu_torch.run --serve``:
        pulls request batches from the launcher's broker over HTTP,
        honors the drain handshake, exits when evicted from the committed
        world.

Every mode but ``--check`` runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _build_model(name: str, in_dim: int, device):
    """``(apply_fn, like_params, sample_input)`` for a named model, its
    weights from ``torch.Generator`` seed 0, in eval mode on ``device``."""
    from ..models.mlp import MLP, ConvNet
    from .replica import module_apply_fn, resolve_device

    gen = torch.Generator().manual_seed(0)
    if name == "mlp":
        model = MLP(in_dim, generator=gen)
        sample = np.zeros((in_dim,), dtype=np.float32)
    elif name == "convnet":
        side = int(round(in_dim ** 0.5)) or 28
        model = ConvNet(image_size=side, generator=gen)
        sample = np.zeros((side, side, 1), dtype=np.float32)
    else:
        raise ValueError(f"unknown --model {name!r} (mlp|convnet)")
    apply_fn, like = module_apply_fn(
        model.to(resolve_device(device)).eval())
    return apply_fn, like, sample


# -- --check -----------------------------------------------------------------
def _check_batcher() -> list:
    """Deterministic flush pins against a scripted clock/source."""
    from .batching import BatchBucketer, ContinuousBatcher

    errors = []
    clock = [0.0]
    ready = [list(range(10))]  # ten instantly available requests

    def pull(n, wait_s):
        out, ready[0] = ready[0][:n], ready[0][n:]
        return out

    b = ContinuousBatcher(pull, max_batch=4, max_wait_ms=50.0,
                          clock=lambda: clock[0])
    if b.next_batch() != [0, 1, 2, 3]:
        errors.append("flush-on-size: expected the first 4 requests")
    # deadline flush: one request now, the next arrives too late
    trickle = [[10], [], [11]]

    def pull_slow(n, wait_s):
        clock[0] += 0.03  # each poll costs 30 ms of scripted time
        return trickle.pop(0) if trickle else []

    b2 = ContinuousBatcher(pull_slow, max_batch=4, max_wait_ms=50.0,
                           clock=lambda: clock[0])
    got = b2.next_batch()
    if got != [10]:
        errors.append(f"flush-on-deadline: expected [10], got {got}")
    bk = BatchBucketer((1, 2, 4, 8))
    pins = [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8)]
    for n, want in pins:
        if bk.bucket(n) != want:
            errors.append(f"bucket({n}) != {want}")
    try:
        bk.bucket(9)
        errors.append("bucket(9) above the ladder top did not raise")
    except ValueError:
        pass
    padded, n = bk.pad(np.ones((3, 5), dtype=np.float32))
    if padded.shape != (4, 5) or n != 3 or padded[3].any():
        errors.append("pad(3->4) wrong shape or nonzero padding rows")
    return errors


def _check_policy() -> list:
    """Hysteresis/cooldown pins on a scripted clock."""
    from .autoscaler import AutoscalePolicy

    errors = []
    clock = [0.0]
    p = AutoscalePolicy(queue_high=4, queue_low=0.5, slo_ms=100,
                        hysteresis_ticks=3, cooldown_s=10,
                        min_replicas=1, max_replicas=0,
                        clock=lambda: clock[0])
    seq = []
    for depth in (10, 10, 3, 10, 10, 10):  # a dip restarts the run
        seq.append(p.decide(queue_depth=depth, p99_ms=None, replicas=1,
                            spares=1))
        clock[0] += 1.0
    if seq != ["hold"] * 5 + ["grow"]:
        errors.append(f"grow hysteresis broke: {seq}")
    # cooldown: immediately idle, but no shrink until 10 s elapsed
    seq2 = []
    for _ in range(4):
        seq2.append(p.decide(queue_depth=0, p99_ms=20.0, replicas=2,
                             spares=0))
        clock[0] += 1.0
    if any(d != "hold" for d in seq2):
        errors.append(f"cooldown violated: {seq2}")
    clock[0] += 10.0
    # the idle run kept counting through the cooldown, so the first
    # post-cooldown tick acts immediately
    d = p.decide(queue_depth=0, p99_ms=20.0, replicas=2, spares=0)
    if d != "shrink":
        errors.append(f"expected shrink after cooldown, got {d}")
    return errors


def run_check(device="cpu") -> int:
    from .plane import run_serving_fixture

    errors = _check_batcher() + _check_policy()
    out = run_serving_fixture(jit=False, service_ms=2.0, seed=7,
                              device=device)
    b = out["broker"]
    if out["offered"] != out["completed"]:
        errors.append(f"dropped requests: offered {out['offered']} != "
                      f"completed {out['completed']}")
    if b["submitted"] != b["completed"] or b["failed"] or b["rejected"]:
        errors.append(f"broker accounting off: {b}")
    if b["duplicates"] or b["requeued"]:
        errors.append(f"duplicate/requeued work in a clean run: {b}")
    if out["serve_p50_ms"] is None or out["serve_p99_ms"] is None:
        errors.append("no latency percentiles computed")
    if out.get("goodput_under_burst") is None:
        errors.append("no burst-window goodput computed")
    if errors:
        print("serving --check FAILED:", file=sys.stderr)
        for e in errors:
            print(f"  {e}", file=sys.stderr)
        return 1
    print(f"serving --check OK: batcher flush pins exact, policy "
          f"hysteresis/cooldown exact, live fixture served "
          f"{out['completed']}/{out['offered']} requests with zero "
          f"drops/duplicates (p50 {out['serve_p50_ms']} ms, p99 "
          f"{out['serve_p99_ms']} ms, goodput_under_burst "
          f"{out['goodput_under_burst']})")
    return 0


def run_bench(as_json: bool, device=None) -> dict:
    from .plane import run_bench_fixture

    out = run_bench_fixture(device)
    if as_json:
        print(json.dumps(out, indent=1))
    else:
        print(f"serving bench: {out['completed']}/{out['offered']} "
              f"requests on {out['replicas']} replicas")
        print(f"  p50 {out['serve_p50_ms']} ms   p99 "
              f"{out['serve_p99_ms']} ms   (SLO {out['slo_ms']} ms)")
        print(f"  goodput {out['goodput']}   under burst "
              f"{out['goodput_under_burst']}")
    return out


# -- serve / worker modes ----------------------------------------------------
def run_serve(args) -> int:
    from ..run.http_server import RendezvousServer
    from .plane import LocalServingPlane
    from .replica import load_params

    apply_fn, like, sample = _build_model(args.model, args.in_dim,
                                          args.device)
    params = load_params(args.checkpoint, like) if args.checkpoint \
        else like
    secret = bytes.fromhex(args.secret) if args.secret else None
    server = RendezvousServer(secret=secret, port=args.port)
    port = server.start()
    # every bucket's graph is captured before the replica pulls
    plane = LocalServingPlane(apply_fn, params, replicas=args.replicas,
                              rdv_server=server, device=args.device,
                              warmup_sample=sample)
    print(f"serving {args.model} on http://0.0.0.0:{port} — signed "
          f"POST /infer, GET /serving ({args.replicas} replica(s); "
          "Ctrl-C stops)")
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        plane.shutdown()
        server.stop()
    return 0


def run_worker(args) -> int:
    from .replica import load_params, serve_worker_loop

    apply_fn, like, sample = _build_model(args.model, args.in_dim,
                                          args.device)
    params = load_params(args.checkpoint, like) if args.checkpoint \
        else like
    serve_worker_loop(apply_fn, params, device=args.device,
                      warmup_sample=sample)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serving",
        description="continuous-batching inference serving on the "
                    "horovod_tpu_torch control plane")
    p.add_argument("--check", action="store_true",
                   help="fixture self-test (on the CPU unless --device)")
    p.add_argument("--bench", action="store_true",
                   help="run the seeded bursty bench fixture")
    p.add_argument("--json", action="store_true",
                   help="machine-readable --bench output")
    p.add_argument("--checkpoint", default=None,
                   help="utils/checkpoint layout dir (step_N + "
                        "COMMITTED sentinels); fresh-init weights "
                        "when omitted")
    p.add_argument("--model", default="mlp", choices=["mlp", "convnet"])
    p.add_argument("--in-dim", type=int, default=32, dest="in_dim",
                   help="flat input feature count (mlp) or image "
                        "pixels (convnet)")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--port", type=int, default=0,
                   help="request-plane port (0 = ephemeral)")
    p.add_argument("--secret", default=None,
                   help="hex HMAC secret for the signed routes")
    p.add_argument("--worker", action="store_true",
                   help="remote replica mode under python -m "
                        "horovod_tpu_torch.run --serve")
    p.add_argument("--device", default=None,
                   help="cuda (the default but for --check) or cpu")
    args = p.parse_args(argv)

    if args.check:
        return run_check(args.device or "cpu")
    if args.bench:
        run_bench(args.json, args.device)
        return 0
    if args.worker:
        return run_worker(args)
    return run_serve(args)


if __name__ == "__main__":
    sys.exit(main() or 0)
