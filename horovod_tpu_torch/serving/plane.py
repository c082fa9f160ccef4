"""In-process serving plane: broker + replicas + elastic driver +
autoscaler wired together — the port of ``horovod_tpu/serving/plane.py``.

This is the serving analog of the elastic runtime's in-process test
worlds: every moving part is real — a live
:class:`~horovod_tpu_torch.run.http_server.RendezvousServer`, real
membership epochs committed by a real
:class:`~horovod_tpu_torch.elastic.driver.ElasticDriver`, real replica
threads pulling from a real broker — but it all runs in one process,
which is what makes the grow/shrink/zero-drop story testable on the
CPU, checkable from the CLI (``python -m horovod_tpu_torch.serving
--check``), and cheap to bench on the card (``--bench``, and
``chip_smoke.py``'s ``serving`` phase).

The plane plays the WORKER side of the membership protocol for the
replicas it hosts: it acks committed epochs (the driver's stability
barrier), starts a replica when its worker is admitted into the world,
and answers the drain handshake (stop pulling → finish in flight →
``drain_ack``) when the driver scales one down.  Worker-side actions
run on their own thread so the driver's blocking drain wait can never
deadlock against them.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..utils.logging import get_logger
from .autoscaler import AutoscalePolicy, ServingAutoscaler
from .broker import RequestBroker
from .frontend import ServingFrontend
from .replica import InferenceReplica

log = get_logger(__name__)

#: the driver's controller for a serving world: no native negotiation
#: controller (replicas run no collective), as the launcher's default
_CONTROLLER = "xla"


class LocalServingPlane:
    """One-process serving world.

    Non-elastic (``elastic=False``): ``replicas`` workers serve a
    fixed fleet — no driver, no threads beyond the replica loops.

    Elastic (``elastic=True``): an :class:`ElasticDriver` owns the
    world (initial workers ``"0"..str(replicas-1)``), ``spare_workers``
    are announced and HELD for the autoscaler, and a policy-driven
    :class:`ServingAutoscaler` commits grow/shrink epochs from the
    broker's load signals.  ``pump_interval`` paces the driver poll.

    ``device`` (default the card) is where every replica serves;
    ``warmup_sample`` (one request's input), when given, makes each
    replica capture every bucket's graph on its own thread before it
    pulls.
    """

    def __init__(self, apply_fn: Callable, params: Any, *,
                 replicas: int = 1,
                 spare_workers: Sequence[str] = (),
                 elastic: bool = False,
                 rdv_server=None,
                 policy: Optional[AutoscalePolicy] = None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 jit: bool = True,
                 min_np: int = 1,
                 drain_timeout_s: float = 10.0,
                 pump_interval: float = 0.05,
                 device=None, warmup_sample=None) -> None:
        self.apply_fn = apply_fn
        self.params = params
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.bucket_sizes = bucket_sizes
        self.jit = jit
        self.device = device
        self.warmup_sample = warmup_sample
        self.drain_timeout_s = drain_timeout_s
        self.pump_interval = pump_interval
        self.broker = RequestBroker()
        self.replicas: Dict[str, InferenceReplica] = {}
        self.epochs_seen: Dict[int, List[str]] = {}
        self._acked: set = set()            # (epoch, worker)
        self._drained: Dict[str, int] = {}  # worker -> epoch at drain
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._owns_server = False
        self.server = rdv_server
        self.driver = None
        self.autoscaler = None
        initial = [str(i) for i in range(replicas)]
        self.hosted = set(initial) | {str(w) for w in spare_workers}
        if elastic:
            if self.server is None:
                from ..run.http_server import RendezvousServer

                self.server = RendezvousServer(secret=None)
                self.server.start()
                self._owns_server = True
            from ..elastic.driver import ElasticDriver

            self.driver = ElasticDriver(self.server, initial,
                                        min_np=min_np,
                                        controller=_CONTROLLER,
                                        drain_timeout=drain_timeout_s)
            self.driver.on_remove = (
                lambda w, drained:
                None if drained else self.broker.requeue(w))
            self.autoscaler = ServingAutoscaler(self.driver, self.broker,
                                                policy)
            self.driver.attach_autoscaler(self.autoscaler)
            for w in spare_workers:
                self.announce_spare(str(w))
        self.frontend = ServingFrontend(self.broker,
                                        autoscaler=self.autoscaler)
        if self.server is not None:
            self.server.attach_serving(self.frontend)
        for w in initial:
            self._start_replica(w)

    # -- replica lifecycle ---------------------------------------------------
    def _start_replica(self, worker: str) -> InferenceReplica:
        rep = InferenceReplica(
            self.broker, self.apply_fn, self.params, replica_id=worker,
            max_batch=self.max_batch, max_wait_ms=self.max_wait_ms,
            bucket_sizes=self.bucket_sizes, jit=self.jit,
            device=self.device)
        self.broker.drain_end(worker)  # re-admitted after an old drain
        self.replicas[worker] = rep.start(self.warmup_sample)
        return rep

    # -- membership worker side ----------------------------------------------
    def announce_spare(self, worker: str) -> None:
        from ..run.http_server import ANNOUNCE_PREFIX, MEMBERSHIP_SCOPE

        self.hosted.add(worker)
        self.server.put(MEMBERSHIP_SCOPE, f"{ANNOUNCE_PREFIX}{worker}",
                        json.dumps({"worker": worker,
                                    "time": time.time()}).encode())

    def start(self) -> "LocalServingPlane":
        """Start the elastic supervision threads (no-op when not
        elastic): the driver pump and the worker-side watcher."""
        if self.driver is None:
            return self
        self._stop.clear()
        for name, fn in (("hvd-serve-pump", self._pump),
                         ("hvd-serve-watch", self._watch)):
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def _pump(self) -> None:
        while not self._stop.is_set():
            try:
                self.driver.poll()
            except Exception:  # noqa: BLE001 — supervision must survive
                log.exception("serving plane driver poll failed")
            self._stop.wait(self.pump_interval)

    def _watch(self) -> None:
        from ..run.http_server import (
            DRAIN_ACK_PREFIX,
            DRAIN_PREFIX,
            MEMBERSHIP_SCOPE,
            READY_PREFIX,
        )

        while not self._stop.is_set():
            try:
                items = self.server.scope_items(MEMBERSHIP_SCOPE)
                raw = items.get("epoch")
                rec = json.loads(raw) if raw is not None else None
                if rec is not None:
                    epoch = int(rec.get("epoch", 0))
                    world = [str(w) for w in rec.get("world", ())]
                    self.epochs_seen.setdefault(epoch, world)
                    for w in world:
                        if w not in self.hosted:
                            continue
                        if (epoch, w) not in self._acked:
                            self.server.put(
                                MEMBERSHIP_SCOPE,
                                f"{READY_PREFIX}{epoch}.{w}",
                                json.dumps({"worker": w}).encode())
                            self._acked.add((epoch, w))
                        if w in self._drained \
                                and epoch > self._drained[w]:
                            # a LATER epoch re-admitted this worker
                            # (the drain's shrink commit bumped the
                            # epoch past the marker) — the marker must
                            # not suppress its replica forever.  Same-
                            # epoch sightings are the pre-commit drain
                            # window, where restarting would resurrect
                            # a zombie replica.
                            del self._drained[w]
                        rep = self.replicas.get(w)
                        if (rep is None or not rep.running) \
                                and w not in self._drained:
                            if rep is not None:
                                # the thread died uncleanly: hand its
                                # in-flight work to the fresh replica
                                self.broker.requeue(w)
                            self._start_replica(w)
                epoch_now = int(rec.get("epoch", 0)) \
                    if rec is not None else 0
                for key in list(items):
                    # "drain_ack." keys don't match the "drain." prefix
                    if not key.startswith(DRAIN_PREFIX):
                        continue
                    w = key[len(DRAIN_PREFIX):]
                    rep = self.replicas.get(w)
                    if rep is None or w in self._drained:
                        continue
                    self._drained[w] = epoch_now
                    if rep.drain(self.drain_timeout_s):
                        self.server.put(
                            MEMBERSHIP_SCOPE, f"{DRAIN_ACK_PREFIX}{w}",
                            json.dumps({"worker": w,
                                        "time": time.time()}).encode())
                    else:
                        # acking a drain that left work in flight would
                        # make the driver record a lossless removal and
                        # skip the requeue; stay silent — the driver's
                        # timeout takes the lossy path, whose on_remove
                        # hook requeues — and hand the leftovers back
                        # ourselves right away
                        log.warning("drain of replica %s timed out "
                                    "with work in flight; not acking",
                                    w)
                        self.broker.requeue(w)
            except Exception:  # noqa: BLE001
                log.exception("serving plane watcher failed")
            self._stop.wait(self.pump_interval / 2.0)

    # -- request plane -------------------------------------------------------
    def submit_and_wait(self, inputs, timeout: Optional[float] = None):
        return self.broker.submit_and_wait(inputs, timeout)

    def status(self) -> dict:
        return self.frontend.report()

    def live_replicas(self) -> List[str]:
        return sorted(w for w, r in self.replicas.items() if r.running)

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        for rep in self.replicas.values():
            rep.stop()
        if self.driver is not None:
            self.driver.shutdown()
        if self._owns_server and self.server is not None:
            self.server.stop()


# -- shared fixtures (CLI --check, bench leg, tests) -------------------------
#: THE bench workload (the reference's, unchanged): ``--bench`` and the
#: chip check's bursty trace take their seed and phases from here
BENCH_FIXTURE_KWARGS = dict(
    jit=True, replicas=2, warmup=True, seed=11, base_rps=40.0,
    burst_rps=200.0, pre_s=0.5, burst_s=0.5, post_s=0.3, slo_ms=100.0)


def run_bench_fixture(device=None) -> dict:
    """The canonical serving bench: :func:`run_serving_fixture` under
    :data:`BENCH_FIXTURE_KWARGS` on ``device`` (default the card)."""
    return run_serving_fixture(**BENCH_FIXTURE_KWARGS, device=device)


def make_mlp_serving_fn(features=(64, 32, 10), in_dim: int = 32,
                        seed: int = 0, device=None):
    """A small MLP for serving fixtures (the port's ``models.mlp.MLP``,
    initialized from ``torch.Generator`` seed ``seed``, in eval mode on
    ``device``, default the card): returns ``(apply_fn, params,
    sample_input)``."""
    import numpy as np

    from ..models.mlp import MLP
    from .replica import module_apply_fn, resolve_device

    model = MLP(in_dim, features=tuple(features),
                generator=torch.Generator().manual_seed(seed))
    model = model.to(resolve_device(device)).eval()
    apply_fn, params = module_apply_fn(model)
    return apply_fn, params, np.zeros((in_dim,), dtype=np.float32)


def run_serving_fixture(*, jit: bool = False, replicas: int = 2,
                        seed: int = 7, base_rps: float = 50.0,
                        burst_rps: float = 250.0, pre_s: float = 0.4,
                        burst_s: float = 0.4, post_s: float = 0.2,
                        slo_ms: float = 250.0,
                        service_ms: float = 0.0,
                        warmup: bool = False, device=None) -> dict:
    """The deterministic serving fixture behind ``python -m
    horovod_tpu_torch.serving --check`` and ``--bench``: a seeded bursty
    open-loop trace against a small MLP replica fleet, summarized as
    ``serve_p50_ms``/``serve_p99_ms``/``goodput_under_burst`` plus the
    broker's zero-drop accounting.  ``device`` defaults to the card."""
    import numpy as np

    from .loadgen import OpenLoopLoadGenerator, bursty_arrivals

    apply_fn, params, sample = make_mlp_serving_fn(seed=seed,
                                                   device=device)
    if service_ms > 0:
        inner = apply_fn

        def apply_fn(p, x, _inner=inner):  # scripted service time
            time.sleep(service_ms / 1000.0 * x.shape[0])
            return _inner(p, x)

    plane = LocalServingPlane(apply_fn, params, replicas=replicas,
                              jit=jit, max_batch=4, max_wait_ms=4.0,
                              device=device)
    try:
        if warmup and jit:
            for rep in plane.replicas.values():
                rep.warmup(sample)
        arrivals, burst_windows = bursty_arrivals(
            base_rps, burst_rps, pre_s=pre_s, burst_s=burst_s,
            post_s=post_s, seed=seed)
        rng = np.random.RandomState(seed)
        inputs = rng.randn(max(len(arrivals), 1),
                           *sample.shape).astype(np.float32)
        gen = OpenLoopLoadGenerator(
            plane.broker.submit, arrivals, lambda i: inputs[i],
            wait=plane.broker.wait, slo_ms=slo_ms, timeout_s=30.0)
        summary = gen.run(burst_windows)
        stats = plane.broker.window_stats()
        return {
            "serve_p50_ms": summary["p50_ms"],
            "serve_p99_ms": summary["p99_ms"],
            "goodput_under_burst": summary.get("goodput_under_burst"),
            "goodput": summary["goodput"],
            "offered": summary["offered"],
            "completed": summary["completed"],
            "slo_ms": slo_ms,
            "replicas": replicas,
            "batches": sum(r.batcher.batches
                           for r in plane.replicas.values()),
            "broker": {k: stats[k] for k in
                       ("submitted", "completed", "failed", "rejected",
                        "duplicates", "requeued")},
        }
    finally:
        plane.shutdown()
