"""Data-parallel training step builder: the port of
``horovod_tpu/training.py``.

Every rank runs the same step on its shard of the global batch: forward
and backward through the model, one fused allreduce of the gradients
(``ops/fusion.py``), the loss averaged across ranks for reporting, and
the optimizer update — the flat fused kernel K1 for a
:class:`~horovod_tpu_torch.optim.fused_update.FusedOptimizer`, or an
optax-style :class:`~horovod_tpu_torch.optim.transforms.Transform` leaf
by leaf (the reference's ``optimizer.update`` + ``optax.apply_updates``
path).  The step's blocks are kept as separate functions, as the
reference keeps them for its profiler.

Where the reference returns a new state from a jitted, donating step,
the port updates the state in place: the model's parameters, its
BatchNorm statistics and the optimizer's flat buffers and count are the
tensors of the :class:`TrainState`.

The reference compiles ``in_graph_steps`` steps into one XLA program.
On a CUDA device the port captures them into one CUDA graph
(:class:`_CompiledStep`): the first call runs eagerly (it loads the
kernels, warms the NCCL communicators and lets cuDNN choose), the second
captures the ``k`` steps — forward, backward, the gradient reduction,
the loss all-reduce and the update — and replays the graph, and every
later call replays it.  On the CPU the step is the eager loop.
``step.eager`` is the same step, never captured.

The gradient reduction is the reference's: the fused buckets
(``ops/fusion.py``) with any compressor, and with error feedback the
residual carried in ``TrainState.residual`` and updated in place;
``op=Adasum``, ``hierarchical`` and ``two_level`` leaf by leaf.  The
error-feedback guard reads the residual's norm once every
``HVD_COMPRESSION_GUARD_STEPS`` calls, after the call, and on divergence
rebuilds the step without compression (captured again).

Every call is traced as the reference traces it: the step-cadence
metrics (``hvd_step_seconds``, ``hvd_steps_total``, ``hvd_samples_total``
and the ``step_seconds`` time series), the timeline's ``record_step`` /
``CYCLE_START`` / ``STEP`` span when ``HVD_TIMELINE`` or
``HVD_TRACE_DIR`` opened one, ``hvd_train_loss`` from the trailing
loss fetch, and the error-feedback guard's residual norm, fall-back
count and ``compression.fallback`` event.  The collectives inside the
step are recorded once a capture (``metrics.traced_recording``).

``profile=True`` (or ``HVD_PROFILE=1``) runs the compute-anatomy
profiler (``timeline/profiler.py``) over its step window: those calls
run the step's four blocks — forward, backward (which computes the
forward again), the gradient all-reduce and the optimizer update — one
by one, eagerly and uncaptured, each closed by a device sync and timed
as a segment, ``in_graph_steps`` times a call.  They update the same
state tensors in place that the captured graph reads, so the replays
after the window resume from the updated state.  With ``profile`` None
and ``HVD_PROFILE`` off the step holds a dormant profiler, disabled (one
bool check a call on the replay path) until the watchdog's arm record
gives it a window (observe/autoarm.py); ``HVD_WATCH_ARM=0`` leaves it
out.

The tuners move the step's knobs through one rebuild seam (the
reference's re-jit): ``autotune=True`` (``HVD_AUTOTUNE``) runs the GP
``ParameterManager`` (``optim/autotune.py``) over the fusion threshold
and hierarchical flag (and, with ``HVD_AUTOTUNE_COMPUTE``, the fused
optimizer and remat), and ``profile_guided=True``
(``HVD_AUTOTUNE_PROFILE_GUIDED``) the replay-driven loop
(``optim/profile_guided.py``: measure a window, plan from the job's own
trace and the profiler's anatomy, apply, verify or roll back).  A
rebuild builds a fresh :class:`_CompiledStep` for the new knobs —
threshold, named buckets, per-bucket compression, hierarchical, the
fused optimizer, remat — which captures its CUDA graph again on its
second call, and releases the old graph and its memory pool; a knob set
whose build equals the live one (only the host-side loss-fetch cadence
moved) keeps the live step.  While a tuner measures, every call is
synced with ``loss.item()`` for honest timing.

A world change rebuilds through the same seam, as the reference's step
re-traces over its new mesh: ``core.reinit()`` (the elastic membership
rebuild) releases every built step's graph before the old process group
is destroyed (``core.bind_to_world``), and the step's next call builds a
fresh :class:`_CompiledStep` against the new world (an eager call, then
a new capture).  The fault harness's step seam (``HVD_FAULT_SPEC``,
``elastic/faults.py``) fires beside the abort check, before each call.

``donate=False`` runs the step on a private copy of the state through
``torch.func.functional_call``: each call returns a new state and leaves
the caller's untouched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from . import core, metrics
from .convert import canonical_batch_stats, canonical_params
from .core import Adasum, Average
from .ops import collectives
from .ops.compression import (
    Compression, ErrorFeedback, ErrorFeedbackGuard, residual_norm,
    from_env as _compression_from_env,
)
from .ops.fusion import allreduce_pytree
from .parallel.hierarchical import (
    hierarchical_allreduce, two_level_allreduce, use_two_level_default,
)
from .optim.distributed import broadcast_parameters
from .optim.fused_update import FusedOptimizer, apply_updates
from .optim.transforms import Transform
from .metrics import timeseries as _timeseries
from .elastic import faults as _faults
from .elastic import heartbeat as _heartbeat
from .timeline.timeline import timeline
from .utils import env as env_util
from .utils.logging import get_logger
from .utils.tree import tree_flatten

log = get_logger(__name__)

#: the tuners' clock (the interval between calls, a call's time)
_clock = time.perf_counter


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]       # canonical order, the model's own
    opt_state: Any
    model_state: Dict[str, torch.Tensor]  # BatchNorm statistics, or {}
    step: int
    #: the error-feedback residual, shaped like ``params`` (``()`` without
    #: error feedback); the step updates its tensors in place
    residual: Any = ()


class TrailingLossFetcher:
    """The trailing loss fetch: ``push(loss)`` is called with every
    step's loss tensor; every ``every`` steps one is retained, and the one
    retained ``every`` steps earlier — long since computed — is read with
    ``.item()``.  The read therefore never waits for the step just
    queued.  ``.value`` is the freshest read (``every``..2×``every`` steps
    behind); ``every <= 0`` disables."""

    def __init__(self, every: int):
        self.every = max(int(every), 0)
        self._pending: list = []
        self._n = 0
        self.value: Optional[float] = None
        self.step: Optional[int] = None

    def push(self, loss: torch.Tensor) -> None:
        if self.every <= 0:
            return
        self._n += 1
        if self._n % self.every:
            return
        self._pending.append((self._n, loss))
        if len(self._pending) > 1:
            self._fetch(*self._pending.pop(0))

    def _fetch(self, n: int, loss: torch.Tensor) -> None:
        self.value = float(loss.item())
        self.step = n
        if metrics.on():
            metrics.TRAIN_LOSS.set(self.value)

    def flush(self) -> Optional[float]:
        """Read every retained loss (end of training); returns the last."""
        while self._pending:
            self._fetch(*self._pending.pop(0))
        return self.value


def scan_steps(step_fn: Callable, k: int) -> Callable:
    """``k`` optimizer steps over the same arguments per call, returning
    the last step's loss.  ``k <= 1``: identity.  A loop of Python here;
    on a CUDA device the compiled step records the whole loop into one
    CUDA graph."""
    if k <= 1:
        return step_fn

    def looped(state, *args):
        for i in range(k):
            # the program's collectives are recorded once, as a lax.scan
            # body is traced once
            with metrics.traced_recording(False) if i \
                    else contextlib.nullcontext():
                state, loss = step_fn(state, *args)
        return state, loss

    return looped


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------
#: the operations the ``dots`` policy saves: the matrix products, as JAX's
#: ``checkpoint_dots`` saves only ``dot_general``; everything else,
#: convolutions included, is recomputed in the backward
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _resolve_remat(policy: Optional[str]) -> Optional[str]:
    if policy is None:
        policy = env_util.get_str(env_util.HVD_REMAT_POLICY)
    if policy in (None, "", "none"):
        return None
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r} (none|full|dots)")
    return policy


@contextlib.contextmanager
def _restoring(buffers: List[torch.Tensor], inner):
    """``inner`` (the recompute's context) with ``buffers`` put back as
    they were before it: the recomputed forward would update the
    BatchNorm running statistics a second time, where the reference
    returns them once, as the forward's aux."""
    saved = [b.clone() for b in buffers]
    try:
        with inner:
            yield
    finally:
        # also when the recompute stops early, once it has what the
        # backward needs
        with torch.no_grad():
            for b, s in zip(buffers, saved):
                b.copy_(s)


def _remat_wrap(fn: Callable, policy: Optional[str],
                buffers: Callable[[], List[torch.Tensor]]) -> Callable:
    """The remat knob (reference ``_remat_wrap``): ``fn`` checkpointed so
    that the backward recomputes its activations instead of holding them.
    ``full`` saves nothing; ``dots`` saves the matrix products' outputs.
    ``buffers()`` gives the module state the recompute must leave as the
    forward left it.  The models draw no random numbers, so no RNG state
    is saved (reading the CUDA RNG state is refused during capture)."""
    if policy is None:
        return fn
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)

    def contexts():
        if policy == "dots":
            forward, recompute = create_selective_checkpoint_contexts(
                list(_DOT_OPS))
        else:
            forward, recompute = (contextlib.nullcontext(),
                                  contextlib.nullcontext())
        return forward, _restoring(buffers(), recompute)

    def checkpointed(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=contexts)

    return checkpointed


# ---------------------------------------------------------------------------
# the compiled step
# ---------------------------------------------------------------------------
def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """The tensors a captured step reads and writes in place: the
    parameters, the statistics, every tensor of the optimizer's state
    (a fused optimizer's flat buffers, count and bias corrections, or a
    transform's moments and count) and the error-feedback residual."""
    return [*state.params.values(), *state.model_state.values(),
            *(t for t in tree_flatten(state.opt_state)[0]
              if torch.is_tensor(t)),
            *tree_flatten(state.residual)[0]]


class _CompiledStep:
    """``entry(state, x, y)`` (``k`` steps) compiled for the state's
    device.  On the CPU every call runs ``entry``.  On a CUDA device the
    first call runs it eagerly (on a side stream, as a capture wants its
    warm-up), the second captures it into a CUDA graph and replays the
    graph once, and every later call copies ``x`` and ``y`` into the
    graph's inputs and replays it.  Every call runs ``k`` steps.

    The graph is bound to the tensors of the state it captured (the
    model's parameters and statistics, the optimizer's state): a call with other tensors raises ``ValueError``.
    A capture or replay that fails raises; nothing falls back to the
    eager step.  A replay runs the captured kernels without their
    wrappers, so the kernels' launch counters count what the host issued
    (the capture once) and not the replays.  ``calls`` counts the calls
    by kind.  The collectives of the step are recorded in the metrics
    plane once: at the capture on a card, at the first call on the CPU
    (``metrics.traced_recording``)."""

    def __init__(self, entry: Callable, k: int,
                 calls: Optional[Dict[str, int]] = None):
        self.entry = entry
        self.k = k
        self.calls = calls if calls is not None \
            else {"eager": 0, "capture": 0, "replay": 0}
        #: this step's own calls by kind (``calls`` may be shared by the
        #: steps one train step rebuilds)
        self.own_calls = {"eager": 0, "capture": 0, "replay": 0}
        #: the world this step was built in (``core.epoch()``; set at its
        #: first call when built before ``init``)
        self.epoch = core.epoch() if core.is_initialized() else None
        core.bind_to_world(self)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: tuple = ()
        #: whether this step ran eagerly once (the next call captures)
        self.warm = False
        #: whether the step's program has been recorded in the metrics
        self.recorded = False
        self.bound: List[int] = []
        self.loss: Optional[torch.Tensor] = None

    def _count(self, kind: str) -> None:
        self.calls[kind] += 1
        self.own_calls[kind] += 1

    def release(self) -> None:
        """Drop the captured graph, its memory pool and its static
        inputs (a rebuild replaced this step, or its world is going)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.inputs = ()
        self.loss = None
        self.bound = []

    def stale(self) -> bool:
        """Whether ``reinit()`` has replaced the world this step was
        built in (its graph held the old communicator)."""
        if not core.is_initialized():
            return False
        if self.epoch is None:
            self.epoch = core.epoch()
        return self.epoch != core.epoch()

    def eager(self, state: TrainState, x, y, record: bool = False):
        self._count("eager")
        self.warm = True
        with metrics.traced_recording(record):
            return self.entry(state, x, y)

    def __call__(self, state: TrainState, x, y):
        if self.graph is not None:
            return self._replay(state, x, y)
        device = next(iter(state.params.values())).device
        if device.type != "cuda":
            record, self.recorded = not self.recorded, True
            return self.eager(state, x, y, record=record)
        if not self.warm:
            return self._warm_up(state, x, y)
        return self._capture(state, x, y)

    def _warm_up(self, state, x, y):
        side = _side_stream(torch.cuda.current_device())
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            state, loss = self.eager(state, x, y)
        torch.cuda.current_stream().wait_stream(side)
        loss.record_stream(torch.cuda.current_stream())
        return state, loss

    def _capture(self, state, x, y):
        self.inputs = (x.clone(), y.clone())
        self.bound = [t.data_ptr() for t in _state_tensors(state)]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"), \
                metrics.traced_recording(not self.recorded):
            state, self.loss = self.entry(state, *self.inputs)
        self.recorded = True
        self.graph = graph
        graph.replay()
        self._count("capture")
        return state, self.loss.clone()

    def _replay(self, state, x, y):
        if [t.data_ptr() for t in _state_tensors(state)] != self.bound:
            raise ValueError(
                "the compiled train step is bound to the state it was "
                "captured with (its parameters, statistics and optimizer "
                "buffers); this state holds other tensors")
        for given, static in zip((x, y), self.inputs):
            if given.shape != static.shape or given.dtype != static.dtype:
                raise ValueError(
                    f"the compiled train step was captured for inputs of "
                    f"shape {tuple(static.shape)} and {static.dtype}, got "
                    f"{tuple(given.shape)} and {given.dtype}")
            static.copy_(given)
        self.graph.replay()
        self._count("replay")
        return state._replace(step=state.step + self.k), self.loss.clone()


#: the warm-up side stream of each card, one for every step built: a
#: new stream a step would give cuBLAS a new workspace, which it keeps
#: for each stream it meets for the life of the process — 65 MiB more
#: memory allocated a rebuild on an H100
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device: int) -> "torch.cuda.Stream":
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _per_leaf(fn: Callable, grads: Dict[str, torch.Tensor]):
    return {k: fn(g) for k, g in grads.items()}


def _profiler(profile: Optional[bool]):
    """The compute-anatomy profiler of a step: ``HVD_PROFILE``'s when
    ``profile`` is None — or, with that off, a dormant one (disabled: one
    bool check a call) that the watchdog's arm record enables for a
    window (observe/autoarm.py; none under ``HVD_WATCH_ARM=0``) — one
    enabled when True (None when it has nowhere to write), none when
    False."""
    from .timeline import profiler as profiler_mod

    if profile is None:
        prof = profiler_mod.from_env()
        if prof is None and env_util.get_bool(env_util.HVD_WATCH_ARM, True):
            prof = profiler_mod.ComputeProfiler(enabled=False)
        return prof
    if profile:
        prof = profiler_mod.ComputeProfiler(enabled=True)
        return prof if prof.enabled else None
    return None


def _nbytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (nested dicts, lists, tuples)."""
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_flatten(tree)[0] if torch.is_tensor(t))


def make_train_step(
    *,
    apply_fn: Callable,
    loss_fn: Callable,
    optimizer: Union[FusedOptimizer, Transform],
    op: str = Average,
    compression=None,
    has_batch_stats: bool = False,
    threshold_bytes: Optional[int] = None,
    donate: bool = True,
    hierarchical: bool = False,
    two_level: Optional[bool] = None,
    autotune: Optional[bool] = None,
    autotune_log_file: Optional[str] = None,
    profile_guided: Optional[bool] = None,
    profile: Optional[bool] = None,
    in_graph_steps: int = 1,
    fused_optimizer: Optional[bool] = None,
    remat_policy: Optional[str] = None,
    loss_fetch_steps: Optional[int] = None,
):
    """Returns ``step(state, x, y) -> (state, loss)``, which runs
    ``in_graph_steps`` optimizer steps per call: on a CUDA device as one
    captured CUDA graph from the second call on (see
    :class:`_CompiledStep`), on the CPU eagerly.

    * ``apply_fn(x) -> logits`` — the model (an ``nn.Module`` in train
      mode) whose parameters are ``state.params``.  BatchNorm statistics
      update in place inside it, so ``has_batch_stats`` only matters to
      :func:`init_train_state`; it is accepted here for the reference's
      signature.
    * ``loss_fn(logits, labels) -> scalar`` (per-rank mean).
    * gradients are bucket-fused and allreduced with ``op`` (Average,
      Sum; Adasum leaf by leaf, ``ops/adasum.py``) and ``compression``
      (default: ``HVD_COMPRESSION`` / ``HVD_COMPRESSION_ERROR_FEEDBACK``:
      none, bf16, int8, fp8 e4m3 / e5m2); the returned loss is averaged
      across ranks.  An :class:`ErrorFeedback` compression carries the
      residual in ``TrainState.residual`` (made by
      ``init_train_state(..., compression=...)``, or on the first call
      when ``in_graph_steps`` is 1), on the fused path only.  Every
      ``HVD_COMPRESSION_GUARD_STEPS`` calls (25) the residual's norm is
      read once; when it diverges the step is rebuilt without
      compression (logged, ``step.guard["trips"]``), the residual left
      as it was.
    * ``hierarchical`` reduces each gradient with the two-level
      local / cross all-reduce (no compression, as the reference);
      ``two_level`` (default ``HVD_TWO_LEVEL_ALLREDUCE``) with
      ``compression`` on the cross stage only
      (``parallel/hierarchical.py``).
    * ``optimizer``: a :class:`FusedOptimizer` (``fused_sgd`` /
      ``fused_adam``) or a transform of ``optim.transforms`` (``sgd``,
      ``adam``, ``adamw``), which always runs per leaf.
    * ``fused_optimizer`` (default ``HVD_FUSED_OPTIMIZER``, on) routes a
      fused optimizer's update through the flat fused kernel instead of
      the per-leaf traversal; both share one flat state.  Set with a
      transform, it is logged and the per-leaf path kept, as the
      reference does.
    * ``remat_policy`` (default ``HVD_REMAT_POLICY``): ``none``, ``full``
      (the backward recomputes the whole forward) or ``dots`` (it keeps
      the matrix products' outputs and recomputes the rest).
    * ``loss_fetch_steps`` (default ``HVD_LOSS_FETCH_STEPS``, 16) drives
      ``step.loss_fetcher``.
    * ``donate`` (default True) updates the caller's state in place;
      False leaves it untouched and returns a new state (module
      docstring).
    * ``autotune`` (default ``HVD_AUTOTUNE``) and ``profile_guided``
      (default ``HVD_AUTOTUNE_PROFILE_GUIDED``) run the tuners through
      the rebuild seam (module docstring); ``step.parameter_manager`` and
      ``step.profile_guided_tuner`` are they (None when off),
      ``step.builds`` the knob sets built so far, the first the initial
      one; ``autotune_log_file`` is the GP's CSV log.

    * ``profile`` (default ``HVD_PROFILE``) runs the compute-anatomy
      profiler over its window (module docstring); ``step.profiler`` is
      it (the dormant one when None and ``HVD_PROFILE`` is off, None
      when False), ``step.profile_losses`` the losses of the
      profiled calls, read after their synced segments (each also sets
      ``hvd_train_loss``).

    The returned loss is a tensor of its own on every call.
    ``step.eager`` is the same step run eagerly, never captured;
    ``step.calls`` counts the calls by kind (``eager``, ``capture``,
    ``replay``; a profiled call is none of them).  A step built before
    :func:`core.reinit` raises on its next call.
    """
    del has_batch_stats
    if compression is None:
        compression = _compression_from_env()
    if two_level is None:
        two_level = use_two_level_default()
    if op != Adasum:
        collectives.reduce_op(op)  # an unknown op raises here
    fusable = isinstance(optimizer, FusedOptimizer)
    if not fusable and not isinstance(optimizer, Transform):
        raise TypeError(
            "the port's train step takes a FusedOptimizer (fused_sgd / "
            "fused_adam) or a transform of optim.transforms (sgd / adam / "
            f"adamw), got {type(optimizer).__name__}")
    if fused_optimizer is None:
        fused_optimizer = env_util.get_bool(env_util.HVD_FUSED_OPTIMIZER,
                                            fusable)
    if fused_optimizer and not fusable:
        log.info("HVD_FUSED_OPTIMIZER is on but the optimizer is not a "
                 "FusedOptimizer — keeping the per-leaf path")
        fused_optimizer = False
    remat = _resolve_remat(remat_policy)
    if loss_fetch_steps is None:
        loss_fetch_steps = env_util.get_int(
            env_util.HVD_LOSS_FETCH_STEPS, env_util.DEFAULT_LOSS_FETCH_STEPS)
    fetcher = TrailingLossFetcher(loss_fetch_steps)
    k = max(in_graph_steps, 1)
    profiler = _profiler(profile)
    if profiler is not None:
        # an arm record polled by the time-series flusher moves its
        # window with the timeline's, or opens the dormant one's
        # (observe/autoarm.py)
        from .observe import autoarm

        autoarm.register_profiler(profiler)
    # donate=False: the step runs on a private copy of the state through
    # torch.func.functional_call (module tensor names by flax key)
    private = None if donate else _PrivateState(apply_fn)

    def _forward(x):
        if private is None:
            return apply_fn(x)
        return torch.func.functional_call(apply_fn, private.tensors(), (x,))

    def _compute_loss(x, y):
        return loss_fn(_forward(x), y)

    def _module_buffers() -> List[torch.Tensor]:
        if private is not None:
            return private.buffers()
        return list(apply_fn.buffers()) if isinstance(apply_fn, nn.Module) \
            else []

    def _grads(state: TrainState, loss):
        names = list(state.params)
        return dict(zip(names, torch.autograd.grad(
            loss, [state.params[n] for n in names])))

    def _ensure_residual(state: TrainState, ef_on: bool) -> TrainState:
        if ef_on and not tree_flatten(state.residual)[0]:
            if k > 1:
                raise ValueError(
                    "error-feedback compression with in_graph_steps > "
                    "1 needs an initialized residual — build the "
                    "state with init_train_state(..., compression=...)")
            state = state._replace(
                residual=ErrorFeedback.init_state(state.params))
        return state

    def build(kn: Dict[str, Any]) -> _CompiledStep:
        """The compiled step for one knob set ``kn`` (the rebuild seam's
        unit: threshold, named buckets, per-bucket compression,
        hierarchical / two-level, the fused optimizer, remat), with its
        blocks as the profiler's segments (``.segments``)."""
        comp, ef_on = kn["compression"], kn["ef"]
        compute_loss = _remat_wrap(_compute_loss, kn["remat"],
                                   _module_buffers)

        def _apply_update(state: TrainState, grads) -> TrainState:
            if kn["fused"]:
                params, opt_state = optimizer.fused_update(
                    grads, state.opt_state, state.params)
            else:
                updates, opt_state = optimizer.update(
                    grads, state.opt_state, state.params)
                apply_updates(state.params, updates)
                params = state.params
            return TrainState(params, opt_state, state.model_state,
                              state.step + 1, state.residual)

        def _reduce_grads(grads, residual):
            if kn["two_level"]:
                return _per_leaf(lambda g: two_level_allreduce(
                    g, op=op, compression=comp), grads)
            if kn["hierarchical"]:
                return _per_leaf(lambda g: hierarchical_allreduce(
                    g, op=op), grads)
            if op == Adasum:
                return _per_leaf(lambda g: collectives.allreduce(
                    g, op=Adasum, compression=comp), grads)
            fuse = {"op": op, "compression": comp,
                    "threshold_bytes": kn["threshold"],
                    "named_buckets": kn["named"],
                    "bucket_compression": kn["bucket_compression"]}
            if not ef_on:
                return allreduce_pytree(grads, **fuse)
            grads, new = allreduce_pytree(grads, residual=residual, **fuse)
            with torch.no_grad():  # in place: a captured graph is bound
                for r, n in zip(tree_flatten(residual)[0],
                                tree_flatten(new)[0]):
                    r.copy_(n)
            return grads

        def per_rank_step(state: TrainState, x, y):
            loss = compute_loss(x, y)
            grads = _reduce_grads(_grads(state, loss), state.residual)
            loss = collectives.allreduce(loss.detach(), op=Average)
            return _apply_update(state, grads), loss

        entry = scan_steps(per_rank_step, in_graph_steps)

        def with_residual(state: TrainState, x, y):
            return entry(_ensure_residual(state, ef_on), x, y)

        # the profiler's segments: the same blocks, one at a time; the
        # forward leaves the module's buffers (BatchNorm statistics) as
        # it found them, as the reference's forward segment discards its
        # new statistics
        def forward(state, x, y):
            with torch.no_grad(), _restoring(_module_buffers(),
                                             contextlib.nullcontext()):
                return _compute_loss(x, y)

        def backward(state, x, y):
            loss = compute_loss(x, y)
            return loss.detach(), _grads(state, loss)

        def grad_allreduce(state, loss, grads):
            return (_reduce_grads(grads, state.residual),
                    collectives.allreduce(loss, op=Average))

        def optimizer_update(state, grads, loss):
            return _apply_update(state, grads), loss

        compiled = _CompiledStep(with_residual, k, calls)
        compiled.segments = {"forward": forward, "backward": backward,
                             "grad_allreduce": grad_allreduce,
                             "optimizer_update": optimizer_update}
        compiled.ef_on = ef_on
        return compiled

    calls = {"eager": 0, "capture": 0, "replay": 0}
    #: the live build and its knobs: ``compiled``, the knob set of the
    #: last rebuild (``threshold``, ``hier``, ``plan``), the base compute
    #: knobs the GP moves (``fused_base``, ``remat_base``), the wire
    #: format (``compression``; none after a guard trip) and the build's
    #: signature (``build_sig``)
    box: Dict[str, Any] = {"fused_base": fused_optimizer,
                           "remat_base": remat, "compression": compression,
                           "compiled": None, "ef": False, "calls": 0,
                           "guard": None, "profiled_last": False}
    #: one entry a build: its knobs (the first is the initial build)
    builds: List[Dict[str, Any]] = []
    fetcher_base_every = fetcher.every

    def _rebuild(threshold_b, hier, plan=None, fused=None, remat_p=None):
        """(Re)build the compiled step for a knob set: the reference's
        re-jit seam, where the port builds a fresh ``_CompiledStep`` (its
        CUDA graph is captured again on its second call) and releases
        the old one's graph and memory pool.  ``plan`` is a
        profile-guided ``FusionPlanSpec``: its explicit buckets override
        the scalar threshold, its per-bucket ``compression`` names the
        wire formats, and its ``compute`` dict the compute knobs (a
        compute-only plan has no buckets).  ``fused`` / ``remat_p`` move
        the base compute knobs (the GP tuner's categorical dimensions);
        None leaves them.  A knob set whose build would be the same as
        the live one (a plan that moves only the host-side loss-fetch
        cadence, or its rollback) keeps the live step: no capture."""
        if fused is not None:
            box["fused_base"] = fused
        if remat_p is not None:
            box["remat_base"] = None if remat_p == "none" else remat_p
        pc = (getattr(plan, "compute", None) or {}) \
            if plan is not None else {}
        fused_eff = bool(pc.get("fused_optimizer", box["fused_base"])) \
            and fusable
        remat_eff = _resolve_remat(pc.get("remat_policy",
                                          box["remat_base"]) or "none")
        # the loss-fetch cadence is host-side: the plan moves it without
        # a rebuild, rollback restores the base
        fetcher.every = max(int(pc.get("loss_fetch_steps",
                                       fetcher_base_every)), 0)
        named = plan.buckets if plan is not None and plan.buckets \
            else None
        bucket_comp = getattr(plan, "compression", None) \
            if plan is not None else None
        if bucket_comp is not None and box.get("guard_tripped"):
            # the guard condemned compression in this job: later plans
            # keep their fusion layout but ship uncompressed
            bucket_comp = None
        if bucket_comp is not None and any(bucket_comp) and k > 1:
            log.info("profile-guided plan carries per-bucket compression "
                     "but in_graph_steps > 1 has no residual carry — "
                     "applying the fusion layout uncompressed")
            bucket_comp = None
        comp = box["compression"]
        # an explicit bucket plan owns the comm layout: the hierarchical
        # and two-level paths reduce per leaf and would drop it
        hier_eff = bool(hier) and named is None
        tlvl = bool(two_level) and named is None
        plan_comp = bucket_comp is not None and any(bucket_comp) \
            and env_util.get_bool(env_util.HVD_COMPRESSION_ERROR_FEEDBACK,
                                  True)
        ef_on = (isinstance(comp, ErrorFeedback) or plan_comp) \
            and not hier_eff and not tlvl
        if ef_on and op == Adasum:
            raise ValueError(
                "error-feedback compression composes with Sum/Average "
                "allreduce, not Adasum (the scale-invariant merge is not "
                "linear in the residual)")
        sig = (threshold_b, hier_eff,
               tuple(tuple(b) for b in named) if named else None,
               tuple(bucket_comp) if bucket_comp else None, id(comp), tlvl,
               fused_eff, remat_eff)
        if sig == box.get("build_sig"):
            box["plan"] = plan
            return
        knobs = {"threshold": threshold_b, "named": named,
                 "bucket_compression": bucket_comp, "compression": comp,
                 "ef": ef_on, "hierarchical": hier_eff, "two_level": tlvl,
                 "fused": fused_eff, "remat": remat_eff}
        old = box["compiled"]
        box.update(compiled=build(knobs), threshold=threshold_b, hier=hier,
                   plan=plan, ef=ef_on, build_sig=sig)
        if old is not None:
            old.release()
        builds.append({**{k_: v for k_, v in knobs.items()
                          if k_ != "compression"},
                       "calls": box["compiled"].own_calls})

    if autotune is None:
        autotune = env_util.get_bool(env_util.HVD_AUTOTUNE)
    pm = None
    if autotune:
        from .optim.autotune import ParameterManager, TunableParams

        initial = TunableParams(
            fusion_threshold_bytes=threshold_bytes
            or env_util.fusion_threshold_bytes(),
            hierarchical_allreduce=hierarchical,
            fused_optimizer=fused_optimizer if fusable else None,
            remat_policy=remat,
        )
        # HVD_AUTOTUNE_COMPUTE widens the GP rotation to the compute
        # knobs — fused_optimizer only where the optimizer can fuse
        tune_compute = env_util.get_bool(env_util.HVD_AUTOTUNE_COMPUTE)
        pm = ParameterManager(
            enabled=True, log_file=autotune_log_file, initial=initial,
            tune_fused_optimizer=tune_compute and fusable,
            tune_remat=tune_compute,
        )
        pm.on_update = lambda p: _rebuild(
            p.fusion_threshold_bytes, p.hierarchical_allreduce,
            p.fusion_plan, fused=p.fused_optimizer, remat_p=p.remat_policy)
        _rebuild(initial.fusion_threshold_bytes,
                 initial.hierarchical_allreduce)
    else:
        _rebuild(threshold_bytes, hierarchical)

    guard_steps = env_util.get_int(env_util.HVD_COMPRESSION_GUARD_STEPS,
                                   env_util.DEFAULT_COMPRESSION_GUARD_STEPS)
    #: the guard's reads of the residual norm, its trips, the last norm
    guard = {"reads": 0, "trips": 0, "norm": None}
    #: calls made (the step-cadence clock) and the last call's start
    cadence = {"calls": 0, "last": 0.0}

    def _record_step_metrics(x) -> None:
        """The step cadence: the interval between successive calls
        (``hvd_step_seconds`` and the ``step_seconds`` series), steps and
        samples issued."""
        now = time.perf_counter()
        cadence["calls"] += 1
        if cadence["last"]:
            dt = now - cadence["last"]
            metrics.STEP_SECONDS.observe(dt)
            if _timeseries.on():
                _timeseries.record(_timeseries.STEP_SECONDS, dt,
                                   step=cadence["calls"])
        cadence["last"] = now
        metrics.STEPS_TOTAL.inc(k)
        try:
            metrics.SAMPLES_TOTAL.inc(int(x.shape[0]) * k)
        except (AttributeError, IndexError, TypeError):
            pass  # a batch without a leading dim: samples stay uncounted

    def _maybe_guard(state: TrainState) -> None:
        """Every ``guard_steps`` calls with error feedback on: one read of
        the residual's norm (one sync, after the call), exported as
        ``hvd_compression_residual_norm``; a divergence rebuilds the step
        without compression (the live plan keeps its fusion layout),
        counted and recorded as a ``compression.fallback`` event."""
        if not box["ef"] or guard_steps <= 0:
            return
        box["calls"] += 1
        if box["calls"] % guard_steps:
            return
        norm = residual_norm(state.residual)
        guard["reads"] += 1
        guard["norm"] = norm
        if metrics.on():
            metrics.COMPRESSION_RESIDUAL_NORM.set(norm)
        if _timeseries.on():
            _timeseries.record(_timeseries.RESIDUAL_NORM_SERIES, norm,
                               step=cadence["calls"])
        if box["guard"] is None:
            box["guard"] = ErrorFeedbackGuard()
        if not box["guard"].observe(norm):
            return
        guard["trips"] += 1
        log.warning(
            "error-feedback residual norm %.3g diverged past %gx its "
            "baseline — falling back to uncompressed allreduce; the "
            "residual stays as it was in TrainState.residual", norm,
            box["guard"].factor)
        if metrics.on():
            metrics.COMPRESSION_FALLBACKS.inc()
        try:
            from .observe import events as events_mod

            events_mod.record_event(
                "compression.fallback", severity="warning",
                payload={"residual_norm": float(norm),
                         "factor": box["guard"].factor,
                         "step": cadence["calls"]})
        except Exception:  # noqa: BLE001 — recording is best-effort
            pass
        box["guard_tripped"] = True
        box["compression"] = Compression.none
        plan = box.get("plan")
        if plan is not None and getattr(plan, "compression", None):
            plan = dataclasses.replace(plan, compression=None)
        _rebuild(box["threshold"], box["hier"], plan)

    profile_losses: List[float] = []

    def _profiled_step(state: TrainState, x, y):
        """One call on the decomposed path: each block run and synced
        under a profiler segment span, ``in_graph_steps`` times.  The
        first profiled call of a build runs the chain once beforehand
        with the state put back afterwards: the warm-up that keeps
        first-run costs out of the spans, and the run whose FLOPs
        (``FlopCounterMode``) and bytes each segment carries; the
        segments' collectives are recorded in it, once, as the
        reference records its separately traced segments."""
        from torch.utils.flop_counter import FlopCounterMode

        compiled = box["compiled"]
        state = _ensure_residual(state, compiled.ef_on)
        seg = compiled.segments
        costs = getattr(compiled, "segment_costs", None)
        if costs is None:
            costs = compiled.segment_costs = {}
            tensors = _state_tensors(state) + _module_buffers()
            with _restoring(tensors, contextlib.nullcontext()), \
                    metrics.traced_recording(True):

                def prep(name, reads, *args):
                    """Run segment ``name`` once under FlopCounterMode;
                    its bytes are those of ``reads`` (what it reads of
                    the state and its arguments) and of its outputs."""
                    with FlopCounterMode(display=False) as counter:
                        out = seg[name](*args)
                    costs[name] = {"flops": counter.get_total_flops(),
                                   "bytes": _nbytes(reads, out)}
                    return out

                model = (state.params, state.model_state, x, y)
                prep("forward", model, state, x, y)
                loss, grads = prep("backward", model, state, x, y)
                grads, loss = prep("grad_allreduce",
                                   (loss, grads, state.residual), state,
                                   loss, grads)
                prep("optimizer_update",
                     (grads, state.params, state.opt_state), state, grads,
                     loss)
                from .timeline.profiler import _sync

                _sync(loss)

        def run(name, *args):
            return profiler.run_segment(name, seg[name], *args,
                                        flops=costs[name]["flops"],
                                        nbytes=costs[name]["bytes"])

        with profiler.step_span(), metrics.traced_recording(False):
            for _ in range(k):
                run("forward", state, x, y)
                loss, grads = run("backward", state, x, y)
                grads, loss = run("grad_allreduce", state, loss, grads)
                state, loss = run("optimizer_update", state, grads, loss)
        value = float(loss.item())  # synced already by its segment
        profile_losses.append(value)
        if metrics.on():
            metrics.TRAIN_LOSS.set(value)
        return state, loss.clone()

    def fetching(eager: bool) -> Callable:
        def call(state: TrainState, x, y):
            # failure-domain seam: a coordinated abort raises
            # HorovodAbortError here, before this rank dispatches a step
            # its dead peer will never join (elastic/heartbeat.py), and
            # the HVD_FAULT_SPEC harness injects its step-seam faults
            _heartbeat.maybe_raise_abort()
            _faults.on_step()
            # the elastic rebuild seam: after core.reinit() the step
            # builds itself again against the new world (reference
            # training.py:781-785); its old graph is already released
            if box["compiled"].stale():
                box["build_sig"] = None
                _rebuild(box["threshold"], box["hier"], box.get("plan"))
            if metrics.on():
                _record_step_metrics(x)
            # a call in the profiler's window takes the decomposed path,
            # inside the same timeline STEP span as any other call
            box["profiled_last"] = profiler is not None \
                and profiler.on_step()
            if box["profiled_last"]:
                run = _profiled_step
            else:
                compiled = box["compiled"]
                run = compiled.eager if eager else compiled
            if private is not None:
                state = private.load(state)
            if timeline.active:
                timeline.record_step(owner="train_step")
                timeline.mark_cycle_start()
                with timeline.span("train_step", "STEP"):
                    state, loss = run(state, x, y)
            else:
                state, loss = run(state, x, y)
            _maybe_guard(state)
            fetcher.push(loss)
            if private is not None:
                state = private.store(state)
            return state, loss

        return call

    step = fetching(False)

    # the profile-guided loop (optim/profile_guided.py): analyze the job's
    # own trace window, apply the winning plan through the same rebuild
    # seam, verify realized against predicted over the next window
    if profile_guided is None:
        profile_guided = env_util.get_bool(
            env_util.HVD_AUTOTUNE_PROFILE_GUIDED)
    tuner = None
    if profile_guided:
        from .optim.profile_guided import tuner_from_env

        trace_dir = env_util.get_str(env_util.HVD_TIMELINE) or \
            env_util.get_str(env_util.HVD_TRACE_DIR)

        def _analyze():
            if not trace_dir:
                return None
            from .timeline.replay import analyze

            # the latest step only: every rank's steps share one DAG
            # shape, and a per-window caller must not replay the whole
            # accumulated trace
            return analyze(trace_dir, last_steps=1).summary

        def _apply_plan(plan):
            if pm is not None:
                if plan is not None:
                    pm.apply_plan(plan)
                else:
                    pm.clear_plan()
            else:
                _rebuild(box["threshold"], box["hier"], plan)

        def _anatomy():
            """The compute tier's plan source: the in-job profiler's
            anatomy when a window has finalized, else this rank's
            compute.json from an earlier run of the same trace dir."""
            if profiler is not None and profiler.anatomy is not None:
                return profiler.anatomy
            if trace_dir:
                from .timeline.profiler import own_rank_anatomy

                return own_rank_anatomy(trace_dir)
            return None

        # knobs the base config already has on are not plan candidates;
        # loss_fetch_steps never is in-job: the tuner's windows sync
        # every step for honest timing, which is what the knob removes
        active = {"loss_fetch_steps": fetcher.every}
        if fused_optimizer:
            active["fused_optimizer"] = True
        tuner = tuner_from_env(_analyze, _apply_plan, anatomy_fn=_anatomy,
                               fused_available=fusable,
                               active_compute=active)
        if not trace_dir:
            log.warning(
                "profile-guided tuning enabled without HVD_TIMELINE/"
                "HVD_TRACE_DIR: no trace window to analyze, the tuner "
                "will idle in its baseline phase")

    if pm is not None or tuner is not None:
        step = _autotuned(step, box, pm, tuner, k)
    step.eager = fetching(True)
    step.calls = calls
    step.loss_fetcher = fetcher
    step.guard = guard
    step.profiler = profiler
    step.profile_losses = profile_losses
    step.builds = builds
    step.parameter_manager = pm
    step.profile_guided_tuner = tuner
    return step


def _autotuned(inner: Callable, box: Dict[str, Any], pm, tuner,
               k: int) -> Callable:
    """``inner`` (the step) under the tuners: the profile-guided loop
    gets the interval between calls (the profiler's window calls left
    out), and the step syncs its loss while that loop measures; while
    the GP tunes, every call is synced (``loss.item()``) and timed, the
    time averaged across processes so every rank scores the same and
    moves its knobs identically, and fed to the ParameterManager as
    gradient bytes over seconds."""
    warm_start = env_util.get_bool(env_util.HVD_AUTOTUNE_WARM_START, True)
    last = [0.0]

    def step_autotuned(state: TrainState, x, y):
        if tuner is not None and tuner.active:
            now = _clock()
            if last[0] and not box["profiled_last"]:
                tuner.on_step(now - last[0])
            last[0] = now
        if pm is None or pm.frozen:
            state, loss = inner(state, x, y)
            if tuner is not None and tuner.measuring:
                loss.item()  # honest timing in the measuring windows
            return state, loss
        if "grad_bytes" not in box:
            # per-call all-reduce volume: the gradients' bytes, once per
            # step of the call
            box["grad_bytes"] = float(_nbytes(state.params)) * k
        if warm_start and not box.get("warm_started"):
            # seed the GP with the α–β model's predicted scores
            box["warm_started"] = True
            from .optim.profile_guided import warm_start_manager

            warm_start_manager(pm, box["grad_bytes"])
        t0 = _clock()
        state, loss = inner(state, x, y)
        loss.item()  # honest timing while tuning
        dt = _clock() - t0
        if box["profiled_last"]:
            # a profiler-window call ran the decomposed path: not this
            # knob vector's step time
            return state, loss
        if core.process_size() > 1:
            # synchronize the measurement instead of the decision
            from . import eager

            dt = float(eager.process_allreduce(
                np.asarray([dt], np.float64), op=Average,
                name="autotune.step_time")[0])
        pm.record_step(box["grad_bytes"], dt)
        return state, loss

    return step_autotuned


class _PrivateState:
    """The state ``donate=False`` steps run on: the step's own copy of
    the caller's state (parameters, statistics, optimizer state and
    residual), made on the first call and overwritten from the caller's
    on every later one, so a captured graph stays bound to it.  The model
    runs on it through ``torch.func.functional_call``; the module's
    buffers that the state does not hold (BatchNorm's
    ``num_batches_tracked``, or statistics without ``has_batch_stats``)
    are copied once and live here too.  Each call returns a new state,
    a copy of this one, and leaves the caller's as it was."""

    def __init__(self, model):
        if not isinstance(model, nn.Module):
            raise TypeError("donate=False runs the model through "
                            "torch.func.functional_call: apply_fn must be "
                            "an nn.Module")
        self.model = model
        ids = {id(t): n for n, t in model.named_parameters()}
        self.param_names = {key: ids[id(t)] for key, t in
                            canonical_params(model).items()}
        bufs = {id(t): n for n, t in model.named_buffers()}
        self.buffer_names = {key: bufs[id(t)] for key, t in
                             canonical_batch_stats(model).items()}
        self.state: Optional[TrainState] = None
        self.extra: Dict[str, torch.Tensor] = {}

    def load(self, given: TrainState) -> TrainState:
        if self.state is None:
            self.state = _copy_state(given)
            held = {self.buffer_names[key] for key in given.model_state}
            self.extra = {n: b.detach().clone() for n, b in
                          self.model.named_buffers() if n not in held}
        else:
            with torch.no_grad():
                for dst, src in zip(_state_tensors(self.state),
                                    _state_tensors(given)):
                    dst.copy_(src)
            self.state = self.state._replace(step=given.step)
        return self.state

    def store(self, out: TrainState) -> TrainState:
        self.state = out
        return _copy_state(out)

    def tensors(self) -> Dict[str, torch.Tensor]:
        t = {self.param_names[key]: p for key, p in self.state.params.items()}
        t.update({self.buffer_names[key]: b
                  for key, b in self.state.model_state.items()})
        t.update(self.extra)
        return t

    def buffers(self) -> List[torch.Tensor]:
        return [*self.state.model_state.values(), *self.extra.values()]


def _copy_tree(node):
    """``node`` (nested dicts, lists, tuples and named tuples of tensors)
    with every tensor copied, structure and order kept."""
    if torch.is_tensor(node):
        return node.detach().clone()
    if isinstance(node, dict):
        return {key: _copy_tree(v) for key, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_copy_tree(v) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_copy_tree(v) for v in node)
    return node


def _copy_state(state: TrainState) -> TrainState:
    """A state of new tensors equal to ``state``'s (parameters stay
    leaves that require grad)."""
    return TrainState(
        params={key: p.detach().clone().requires_grad_(p.requires_grad)
                for key, p in state.params.items()},
        opt_state=_copy_tree(state.opt_state),
        model_state=_copy_tree(state.model_state),
        step=state.step, residual=_copy_tree(state.residual))


def init_train_state(model: nn.Module,
                     optimizer: Union[FusedOptimizer, Transform], *,
                     has_batch_stats: bool = False, compression=None,
                     device=None) -> TrainState:
    """The state of ``model`` on this rank's device: every rank builds
    the model from the same seed, then takes rank 0's parameters and
    statistics (``broadcast_parameters``).  Moves ``model`` to ``device``
    (default :func:`core.device`) and into train mode.  A torch module
    knows its shapes, so the reference's ``sample_input`` is not
    needed.  Pass the ``compression`` the step uses: an
    :class:`ErrorFeedback` gets its zero residual here (needed for
    ``in_graph_steps > 1``)."""
    model.to(device if device is not None else core.device()).train()
    params = canonical_params(model)
    model_state = canonical_batch_stats(model) if has_batch_stats else {}
    broadcast_parameters(params)
    broadcast_parameters(model_state)
    residual = ErrorFeedback.init_state(params) \
        if isinstance(compression, ErrorFeedback) else ()
    return TrainState(params=params, opt_state=optimizer.init(params),
                      model_state=model_state, step=0, residual=residual)


def shard_batch(batch: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch, on its device: rank ``r``
    takes ``[r·b, (r+1)·b)`` with ``b = len(batch) // size``."""
    n, r = core.size(), core.rank()
    if batch.shape[0] % n:
        raise ValueError(f"global batch {batch.shape[0]} is not divisible "
                         f"by the world size {n}")
    b = batch.shape[0] // n
    return batch[r * b:(r + 1) * b].to(core.device(), non_blocking=True)


def shard_sequence(batch: torch.Tensor) -> torch.Tensor:
    """This rank's block of the sequence (dim 1) of a batch that every
    rank holds whole, on its device: rank ``r`` takes positions ``[r·s,
    (r+1)·s)`` with ``s = batch.shape[1] // size`` (the reference's
    ``P(None, AXIS)`` placement, sequence parallelism's)."""
    n, r = core.size(), core.rank()
    if batch.shape[1] % n:
        raise ValueError(f"sequence {batch.shape[1]} is not divisible by "
                         f"the world size {n}")
    s = batch.shape[1] // n
    return batch[:, r * s:(r + 1) * s].to(core.device(), non_blocking=True)
