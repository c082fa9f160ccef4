"""Inference replica worker: checkpoint → batched forward, one CUDA graph a
padded bucket → pull loop.  The port of ``horovod_tpu/serving/replica.py``.

One replica = one worker in the serving world.  It loads trained
parameters (``utils/checkpoint`` layout, optionally compressed at rest
with the int8 / fp8 quantizers for serving density), runs the batched
forward once per padded bucket size (serving/batching.py bounds the
bucket ladder, so the graphs are bounded), and pulls work from the shared
request broker — in process, or over the rendezvous server's
``POST /serving/pull`` route when the replica runs on another host
(:class:`RemoteSource`).

Where the reference lets ``jax.jit`` specialize the forward by shape, a
replica on the card captures **one CUDA graph a padded bucket** (in
``torch.inference_mode()``): a static input and output buffer for each
bucket, and a pinned host buffer the batch is stacked into.  A batch is
stacked and zero-padded into that pinned buffer, copied in, the graph
replays, and the real rows are copied back out.  Captures run on the
card's shared warm-up stream (``training._side_stream``: a new stream a
replica would pin cuBLAS a new workspace) with
``capture_error_mode="thread_local"``, one capture at a time, so a
replica can capture its graphs while another one replays.  On a CPU
device the forward runs eagerly; ``jit=False`` runs it eagerly on the
card too.

Draining (the lossless scale-down handshake): :meth:`drain` stops the
pull loop from receiving new work, finishes everything in flight, and
returns — the elastic driver commits the shrink epoch only after the
ack (elastic/driver.py ``remove(drain=True)``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import env as env_util
from ..utils.logging import get_logger
from .batching import BatchBucketer, ContinuousBatcher, bucket_sizes_from_env

log = get_logger(__name__)


# -- weight compression at rest ----------------------------------------------
#: the at-rest wires: (storage dtype, largest magnitude), the reference's
#: ``ops/compression._numpy_wire`` table
WIRES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 57344.0),
}


def _wire(name: str) -> Tuple[torch.dtype, float]:
    """A wire's (dtype, headroom).  An unknown wire — ``bf16`` among them,
    which the reference's knob documents but its quantizer cannot make —
    raises a ``ValueError`` naming the supported ones."""
    if name not in WIRES:
        raise ValueError(
            f"weight compression {name!r} is not supported at rest; the "
            f"supported wires are {', '.join(WIRES)}")
    return WIRES[name]


def _map(fn, tree, is_leaf=lambda x: False):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and torch.is_tensor(x[0]) \
        and isinstance(x[1], float)


def quantize(x: torch.Tensor, wire: str = "int8"
             ) -> Tuple[torch.Tensor, float]:
    """One tensor at rest: ``(q, dequant_factor)`` with a per-tensor
    scale (group size 1: stored weights need no summation headroom).
    The arithmetic is the reference's ``numpy_quantize``: int8 rounds
    ``x / scale * 127`` in float64 and clips; fp8 casts ``x / scale *
    max`` computed in float32.  q and the factor are bit-equal to it."""
    dtype, headroom = _wire(wire)
    scale = max(float(x.detach().abs().max()), 1e-30)
    if dtype == torch.int8:
        q = torch.round(x.detach().double() / scale * headroom) \
            .clamp_(-headroom, headroom).to(dtype)
    else:
        f32 = dict(dtype=torch.float32, device=x.device)
        q = (x.detach().float() / torch.tensor(scale, **f32)
             * torch.tensor(headroom, **f32)).to(dtype)
    return q, scale / headroom


def compress_params(params: Any, wire: str = "int8") -> Tuple[Any, dict]:
    """Quantize every float leaf of ``params`` (a tree of tensors or
    arrays) at rest: each becomes a ``(q, dequant_factor)`` pair (see
    :func:`quantize`); other leaves are kept.  ``info`` carries the byte
    ratio the serving-density story is about."""
    _wire(wire)
    orig = comp = 0

    def _one(leaf):
        nonlocal orig, comp
        t = leaf if torch.is_tensor(leaf) else torch.as_tensor(
            np.asarray(leaf))
        nbytes = t.numel() * t.element_size()
        orig += nbytes
        if not t.is_floating_point():
            comp += nbytes
            return leaf
        q, factor = quantize(t, wire)
        comp += q.numel() * q.element_size()
        return (q, factor)

    tree = _map(_one, params)
    info = {"wire": wire, "orig_bytes": orig, "compressed_bytes": comp,
            "ratio": round(orig / comp, 3) if comp else None}
    return tree, info


def decompress_params(tree: Any, dtype=torch.float32) -> Any:
    """Materialize a :func:`compress_params` tree back to float tensors
    (``q · factor`` in float64, then ``dtype``), once at replica start:
    weights are compressed at rest, not per batch."""
    return _map(lambda p: (p[0].double() * p[1]).to(dtype) if _is_pair(p)
                else p, tree, _is_pair)


def load_params(checkpoint_path: str, like: Any,
                step: Optional[int] = None) -> Any:
    """Restore a trained parameter tree for serving — the
    ``utils/checkpoint`` layout (``step_N`` dirs + COMMITTED sentinels)
    without the training-time broadcast: a serving replica is a
    standalone process, not a rank in a training world."""
    from ..utils.checkpoint import restore_checkpoint

    return restore_checkpoint(checkpoint_path, like, step=step,
                              broadcast=False)


def module_apply_fn(module: torch.nn.Module) -> Tuple[Callable, dict]:
    """``(apply_fn, params)`` for an ``nn.Module``: ``apply_fn(params,
    batch)`` runs the module's forward over ``params`` (its parameters
    and buffers by name, ``torch.func.functional_call``), the shape of
    the reference's ``model.apply``.  Put the module in eval mode first."""
    params = dict(module.named_parameters())
    params.update(module.named_buffers())

    def apply_fn(p, x):
        return torch.func.functional_call(module, p, (x,))

    return apply_fn, {k: v.detach() for k, v in params.items()}


def resolve_device(device=None) -> torch.device:
    """The card (``cuda``, the current device) unless ``device`` names
    another; no card and no ``device`` raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "serving: no CUDA device is available; pass device='cpu' "
                "to serve on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


#: one capture at a time on a card's shared warm-up stream
_CAPTURE_LOCK = threading.Lock()

#: how many batches' end times a replica keeps
BATCH_TIMES = 4096


class _BucketGraph:
    """One padded shape's CUDA graph and its buffers: pinned host input
    and output, static device input and output."""

    def __init__(self, shape: Tuple[int, ...], device: torch.device,
                 apply_fn: Callable, params: Any) -> None:
        from ..training import _side_stream

        self.host_in = torch.zeros(shape, dtype=torch.float32,
                                   pin_memory=True)
        self.x = torch.zeros(shape, dtype=torch.float32, device=device)
        side = _side_stream(device.index)
        with _CAPTURE_LOCK, torch.inference_mode():
            # the warm-up forward on the capture stream (lazy cuBLAS /
            # cuDNN state is made here, not inside the capture)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                apply_fn(params, self.x)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.out = apply_fn(params, self.x)
        self.host_out = torch.empty(self.out.shape, dtype=self.out.dtype,
                                    pin_memory=True)


def _host_rows(out: torch.Tensor) -> np.ndarray:
    out = out.detach()
    if out.dtype in (torch.bfloat16, torch.float16):
        out = out.float()
    return out.cpu().numpy()


class InferenceReplica:
    """One pull→batch→forward→complete worker.

    ``apply_fn(params, batch) -> outputs`` is the model's batched
    forward (:func:`module_apply_fn` makes one from an ``nn.Module``).
    ``source`` is anything broker-shaped (``pull``/``complete``/``fail``
    keyed by this replica's id) — the in-process broker or a
    :class:`RemoteSource`.  ``device`` (default the card) is where the
    parameters live and the forward runs.  ``jit=False`` runs the forward
    eagerly with no graph (the tests use it to script service times)."""

    def __init__(self, source, apply_fn: Callable, params: Any, *,
                 replica_id: str, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 weight_compression: Optional[str] = None,
                 jit: bool = True, device=None) -> None:
        self.source = source
        self.apply_fn = apply_fn
        self.replica_id = str(replica_id)
        self.jit = jit
        self.device = resolve_device(device)
        self.compression_info: Optional[dict] = None
        wc = weight_compression if weight_compression is not None \
            else env_util.get_str(env_util.HVD_SERVE_WEIGHT_COMPRESSION)
        if wc and wc != "none":
            # compressed at rest for density; materialized once here
            compressed, self.compression_info = compress_params(params, wc)
            params = decompress_params(compressed)
        self.params = _map(
            lambda t: (t if torch.is_tensor(t) else torch.as_tensor(
                np.asarray(t))).to(self.device)
            if torch.is_tensor(t) or isinstance(t, np.ndarray) else t,
            params)
        max_batch = int(
            max_batch if max_batch is not None
            else env_util.get_int(env_util.HVD_SERVE_MAX_BATCH,
                                  env_util.DEFAULT_SERVE_MAX_BATCH))
        self.bucketer = BatchBucketer(
            bucket_sizes if bucket_sizes is not None
            else bucket_sizes_from_env(max_batch))
        top = self.bucketer.sizes[-1]
        if max_batch > top:
            # a batch larger than the top rung has no padded shape to
            # land in — admitting one would fail wholesale
            log.warning("HVD_SERVE_MAX_BATCH %d exceeds the bucket "
                        "ladder top %d; capping the batcher", max_batch,
                        top)
            max_batch = top
        self.batcher = ContinuousBatcher(
            lambda n, wait_s: source.pull(self.replica_id, n, wait_s),
            max_batch=max_batch, max_wait_ms=max_wait_ms)
        self._graphs: Dict[Tuple[int, ...], _BucketGraph] = {}
        self._buckets_seen: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()
        self.requests = 0
        self.batches = 0
        #: monotonic end times of the first and the last BATCH_TIMES
        #: processed batches, and the (start, end) of :meth:`warmup` and
        #: of :meth:`drain`
        self.first_batch_time: Optional[float] = None
        self.batch_times: deque = deque(maxlen=BATCH_TIMES)
        self.warmup_window: Optional[Tuple[float, float]] = None
        self.drain_window: Optional[Tuple[float, float]] = None
        #: set once the loop thread pulls (after its warm-up, which
        #: leaves its exception here if it raised)
        self.ready = threading.Event()
        self.warmup_error: Optional[BaseException] = None

    # -- forward -------------------------------------------------------------
    @property
    def graphed(self) -> bool:
        return self.jit and self.device.type == "cuda"

    @property
    def recompiles(self) -> int:
        """Distinct padded batch shapes executed (one CUDA graph each on
        the card) — bounded by the bucket ladder."""
        return len(self._buckets_seen)

    def stack(self, batch) -> Tuple[Any, int]:
        """Stack a pulled batch's inputs, zero-padded to its bucket: into
        the bucket graph's pinned host buffer on the card (the graph is
        captured at a shape's first batch), into an array elsewhere.
        Returns ``(padded, n)``."""
        rows = [np.asarray(r.inputs) for r in batch]
        n = len(rows)
        shape = (self.bucketer.bucket(n),) + rows[0].shape
        if any(r.shape != rows[0].shape for r in rows):
            raise ValueError("requests in one batch have inputs of "
                             f"different shapes {[r.shape for r in rows]}")
        self._buckets_seen.add(shape)
        if not self.graphed:
            padded, _ = self.bucketer.pad(np.stack(rows))
            return padded, n
        g = self._graphs.get(shape)
        if g is None:
            g = self._graphs[shape] = _BucketGraph(
                shape, self.device, self.apply_fn, self.params)
        host = g.host_in.numpy()
        for i, r in enumerate(rows):
            host[i] = r
        host[n:] = 0.0
        return g, n

    def forward(self, padded) -> Any:
        """Run a stacked batch: on the card copy the pinned input in and
        replay its graph (both queued on the current stream); elsewhere
        the eager forward.  Returns what :meth:`fetch` reads."""
        if isinstance(padded, _BucketGraph):
            padded.x.copy_(padded.host_in, non_blocking=True)
            padded.graph.replay()
            return padded
        with torch.inference_mode():
            return self.apply_fn(self.params, torch.as_tensor(
                np.ascontiguousarray(padded)).to(self.device))

    def fetch(self, out, n: int) -> np.ndarray:
        """The first ``n`` rows of a forward's output on the host."""
        if isinstance(out, _BucketGraph):
            out.host_out.copy_(out.out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            return _host_rows(out.host_out[:n]).copy()
        return _host_rows(out[:n])

    def eager_forward(self, padded: np.ndarray) -> np.ndarray:
        """The forward of a padded batch with no graph, all its rows —
        what each bucket's graph is held to."""
        with torch.inference_mode():
            return _host_rows(self.apply_fn(self.params, torch.as_tensor(
                np.ascontiguousarray(padded)).to(self.device)))

    def warmup(self, sample) -> None:
        """Run every bucket size once with ``sample`` (one request's
        input), so each padded shape's graph is captured before the first
        real request on it."""
        t0 = time.monotonic()
        sample = np.asarray(sample)

        class _R:
            inputs = sample

        for b in self.bucketer.sizes:
            padded, n = self.stack([_R] * b)
            self.fetch(self.forward(padded), n)
        self.warmup_window = (t0, time.monotonic())

    def process(self, batch) -> None:
        """Run one pulled batch: stack, pad to the bucket, forward,
        complete each request with its row.  Per-request failures fail
        that request, not the replica."""
        try:
            padded, n = self.stack(batch)
            out = self.fetch(self.forward(padded), n)
        except Exception as e:  # noqa: BLE001 — a poison batch must
            for req in batch:   # not kill the replica loop
                try:
                    self.source.fail(req, f"{type(e).__name__}: {e}",
                                     self.replica_id)
                except Exception:  # noqa: BLE001
                    log.warning("could not deliver failure for "
                                "request %s", req.id)
            return
        for i, req in enumerate(batch):
            # per-request delivery: one failed result post (past its
            # retry budget) must not strand the REST of a computed
            # batch in the broker's in-flight table
            try:
                self.source.complete(req, out[i], self.replica_id)
            except Exception as e:  # noqa: BLE001
                try:
                    self.source.fail(
                        req, f"result delivery failed: {e}",
                        self.replica_id)
                except Exception:  # noqa: BLE001
                    log.warning("stranded request %s: result "
                                "delivery failed twice (%s)", req.id, e)
        self.requests += len(batch)
        self.batches += 1
        self.batch_times.append(time.monotonic())
        if self.first_batch_time is None:
            self.first_batch_time = self.batch_times[-1]

    # -- the loop ------------------------------------------------------------
    def start(self, warmup_sample=None) -> "InferenceReplica":
        """Start the pull loop on its own thread; with ``warmup_sample``
        the thread first runs :meth:`warmup` (its captures then overlap
        other replicas' replays)."""
        self._stop_flag.clear()
        self.ready.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(warmup_sample,), daemon=True,
            name=f"hvd-serve-replica-{self.replica_id}")
        self._thread.start()
        return self

    def _loop(self, warmup_sample=None) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # per-thread current card
        if warmup_sample is not None:
            try:
                self.warmup(warmup_sample)
            except Exception as e:  # noqa: BLE001 — serve anyway: a
                # bucket's graph is then captured at its first batch
                log.exception("replica %s warm-up failed",
                              self.replica_id)
                self.warmup_error = e
        self.ready.set()
        while not self._stop_flag.is_set():
            try:
                batch = self.batcher.next_batch(idle_wait_s=0.05)
                if batch:
                    self.process(batch)
            except Exception:  # noqa: BLE001 — a transient source
                # error (e.g. one refused RemoteSource HTTP pull) must
                # not kill the replica thread while its worker is still
                # in the committed world
                log.exception("replica %s pull loop error; retrying",
                              self.replica_id)
                self._stop_flag.wait(0.2)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Lossless stop: no new pulls, finish in flight, join the
        loop.  Returns True when everything completed in time."""
        if timeout is None:
            timeout = env_util.get_float(
                env_util.HVD_SERVE_DRAIN_TIMEOUT_SECONDS,
                env_util.get_float(env_util.HVD_ELASTIC_TIMEOUT_SECONDS,
                                   env_util.DEFAULT_ELASTIC_TIMEOUT_SECONDS))
        t0 = time.monotonic()
        drain_begin = getattr(self.source, "drain_begin", None)
        if drain_begin is not None:
            drain_begin(self.replica_id)
        drained = True
        wait_drained = getattr(self.source, "wait_drained", None)
        if wait_drained is not None:
            drained = wait_drained(self.replica_id, timeout)
        # the loop thread joining means the current batch ran to
        # completion — for sources with no wait_drained (RemoteSource:
        # the in-flight table lives launcher-side) this is the only
        # local evidence the drain actually finished; a slow batch
        # outliving the timeout must NOT read as drained
        joined = self.stop(join_timeout=timeout)
        self.drain_window = (t0, time.monotonic())
        return drained and joined

    def stop(self, join_timeout: float = 5.0) -> bool:
        """Stop the loop; True iff it joined inside ``join_timeout``
        (False means a batch is still executing)."""
        self._stop_flag.set()
        joined = True
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            joined = not self._thread.is_alive()
            if not joined:
                log.warning("replica %s loop did not stop within %.1fs",
                            self.replica_id, join_timeout)
            self._thread = None
        return joined

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


class RemoteSource:
    """Broker-shaped adapter for replicas on other hosts: ``pull`` and
    ``complete``/``fail`` ride the rendezvous server's signed
    ``POST /serving/pull`` / ``POST /serving/result`` routes
    (run/http_client.py; JSON float32 lists, the reference's bytes), so a
    remote replica worker runs the exact same :class:`InferenceReplica`
    loop as an in-process one."""

    class _Req:
        __slots__ = ("id", "inputs")

        def __init__(self, req_id: int, inputs) -> None:
            self.id = req_id
            self.inputs = inputs

    def __init__(self, addr: str, port: int,
                 secret: Optional[bytes] = None) -> None:
        self.addr = addr
        self.port = port
        self.secret = secret

    @classmethod
    def from_env(cls) -> "RemoteSource":
        """Wire from the launcher-exported rendezvous env
        (HVD_METRICS_KV_ADDR/PORT/SECRET) — what ``python -m
        horovod_tpu_torch.serving --worker`` under ``python -m
        horovod_tpu_torch.run --serve`` uses."""
        addr = env_util.get_str(env_util.HVD_METRICS_KV_ADDR)
        port = env_util.get_int(env_util.HVD_METRICS_KV_PORT, 0)
        if not addr or not port:
            raise RuntimeError(
                "RemoteSource needs the rendezvous wiring "
                "(HVD_METRICS_KV_ADDR/PORT); run under python -m "
                "horovod_tpu_torch.run --serve or pass addr/port "
                "explicitly")
        secret_hex = env_util.get_str(env_util.HVD_METRICS_SECRET)
        return cls(addr, port,
                   bytes.fromhex(secret_hex) if secret_hex else None)

    def pull(self, replica_id: str, max_n: int, wait_s: float):
        from ..run.http_client import serve_pull

        out = serve_pull(self.addr, self.port, replica_id, max_n,
                         wait_ms=wait_s * 1000.0, secret=self.secret,
                         timeout=wait_s + 10.0)
        return [self._Req(r["id"], np.asarray(r["inputs"],
                                              dtype=np.float32))
                for r in out.get("requests", ())]

    def complete(self, req, output, replica_id: str) -> bool:
        from ..run.http_client import serve_result

        out = serve_result(self.addr, self.port, replica_id,
                           [{"id": req.id,
                             "output": np.asarray(output).tolist()}],
                           secret=self.secret)
        return bool(out.get("accepted"))

    def fail(self, req, error: str, replica_id: str) -> bool:
        from ..run.http_client import serve_result

        out = serve_result(self.addr, self.port, replica_id,
                           [{"id": req.id, "error": str(error)}],
                           secret=self.secret)
        return bool(out.get("accepted"))

    # drain for a remote replica is driven by the membership drain key
    # (elastic/membership.py drain_requested/ack_drain); the broker-side
    # drain_begin is issued by the driver's handshake, so the remote
    # source needs no local drain state.


def serve_worker_loop(apply_fn: Callable, params: Any, *,
                      replica_id: Optional[str] = None,
                      source=None, poll_s: float = 0.5,
                      stop_event: Optional[threading.Event] = None,
                      device=None, warmup_sample=None,
                      on_ready: Optional[Callable[[], None]] = None) -> None:
    """The ``python -m horovod_tpu_torch.serving --worker`` body: run an
    :class:`InferenceReplica` on ``device`` (default the card) against the
    launcher's broker and honor the elastic drain handshake — on a
    ``drain.<worker>`` key, finish in flight, ack, and exit; on eviction
    from the committed world, exit.  ``warmup_sample`` captures every
    bucket's graph before the first pull; ``on_ready()`` is called once
    the replica pulls."""
    from ..elastic import membership

    wid = replica_id if replica_id is not None else membership.worker_id()
    source = source if source is not None else RemoteSource.from_env()
    replica = InferenceReplica(source, apply_fn, params,
                               replica_id=str(wid), device=device)
    replica.start(warmup_sample)
    try:
        while stop_event is None or not stop_event.is_set():
            if replica.ready.wait(poll_s) and on_ready is not None:
                on_ready()
                on_ready = None
            time.sleep(poll_s)
            if membership.drain_requested() is not None:
                if replica.drain():
                    membership.ack_drain()
                else:
                    # work still in flight: an ack would record this as
                    # a lossless drain and skip the launcher-side
                    # requeue — let the driver's timeout take the
                    # lossy path instead
                    log.warning("drain timed out with work in flight; "
                                "exiting without ack")
                return
            rec = membership.current_record()
            try:
                rec = membership.get_epoch_record() or rec
            except Exception:  # noqa: BLE001 — keep serving through a
                pass            # rendezvous blip
            if rec is not None and str(wid) not in rec.get("world", ()):
                log.info("worker %s no longer in the committed world; "
                         "stopping replica", wid)
                return
    finally:
        replica.stop()
