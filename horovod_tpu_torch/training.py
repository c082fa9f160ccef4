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
kernels, warms the NCCL communicator and lets cuDNN choose), the second
captures the ``k`` steps — forward, backward, the bucketed all-reduce,
the loss all-reduce and the update — and replays the graph, and every
later call replays it.  On the CPU the step is the eager loop.
``step.eager`` is the same step, never captured.

Knobs whose slice has not landed yet (error-feedback compression,
``two_level``, ``hierarchical``, ``autotune``, ``profile_guided``,
``profile``, ``donate=False``, and their ``HVD_*`` environment defaults)
raise ``NotImplementedError``; none is silently ignored.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import torch
from torch import nn

from . import core
from .convert import canonical_batch_stats, canonical_params
from .core import Average
from .ops import collectives
from .ops.compression import Compression, from_env as _compression_from_env
from .ops.fusion import allreduce_pytree
from .optim.fused_update import FusedOptimizer, apply_updates
from .optim.transforms import Transform
from .utils import env as env_util
from .utils.logging import get_logger
from .utils.tree import tree_flatten

log = get_logger(__name__)


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]       # canonical order, the model's own
    opt_state: Any
    model_state: Dict[str, torch.Tensor]  # BatchNorm statistics, or {}
    step: int
    #: error-feedback residual; always empty until compression lands
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
        for _ in range(k):
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
    parameters, the statistics and every tensor of the optimizer's state
    (a fused optimizer's flat buffers, count and bias corrections, or a
    transform's moments and count)."""
    return [*state.params.values(), *state.model_state.values(),
            *tree_flatten(state.opt_state)[0]]


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
    by kind."""

    def __init__(self, entry: Callable, k: int):
        self.entry = entry
        self.k = k
        self.calls = {"eager": 0, "capture": 0, "replay": 0}
        self.epoch = core.epoch() if core.is_initialized() else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: tuple = ()
        self.bound: List[int] = []
        self.loss: Optional[torch.Tensor] = None

    def check_world(self) -> None:
        """A step built for a world that reinit() has replaced raises: its
        graph holds the old communicator."""
        if self.epoch is None:
            self.epoch = core.epoch()
        elif self.epoch != core.epoch():
            raise RuntimeError(
                "this train step was built before horovod_tpu_torch."
                "reinit(); build it again with make_train_step")

    def eager(self, state: TrainState, x, y):
        self.check_world()
        self.calls["eager"] += 1
        return self.entry(state, x, y)

    def __call__(self, state: TrainState, x, y):
        self.check_world()
        if self.graph is not None:
            return self._replay(state, x, y)
        device = next(iter(state.params.values())).device
        if device.type != "cuda":
            return self.eager(state, x, y)
        if not self.calls["eager"]:
            return self._warm_up(state, x, y)
        return self._capture(state, x, y)

    def _warm_up(self, state, x, y):
        side = torch.cuda.Stream()
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
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            state, self.loss = self.entry(state, *self.inputs)
        self.graph = graph
        graph.replay()
        self.calls["capture"] += 1
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
        self.calls["replay"] += 1
        return state._replace(step=state.step + self.k), self.loss.clone()


def _not_ported(knob: str) -> NotImplementedError:
    return NotImplementedError(
        f"make_train_step: {knob} is not ported yet (it lands with a later "
        "slice of horovod_tpu_torch)")


def _refuse_unported(*, compression, hierarchical, two_level, autotune,
                     profile_guided, profile, donate, op):
    if hierarchical:
        raise _not_ported("hierarchical allreduce")
    if two_level or (two_level is None and env_util.get_bool(
            env_util.HVD_TWO_LEVEL_ALLREDUCE)):
        raise _not_ported("two_level allreduce")
    if autotune or (autotune is None
                    and env_util.get_bool(env_util.HVD_AUTOTUNE)):
        raise _not_ported("autotune")
    if profile_guided or (profile_guided is None and env_util.get_bool(
            env_util.HVD_AUTOTUNE_PROFILE_GUIDED)):
        raise _not_ported("profile_guided tuning")
    if profile or (profile is None
                   and env_util.get_bool(env_util.HVD_PROFILE)):
        raise _not_ported("the compute-anatomy profiler")
    if not donate:
        raise _not_ported("donate=False (the port updates the state in "
                          "place)")
    if compression not in (Compression.none, Compression.bf16):
        raise _not_ported(f"compression {compression!r}")
    collectives.reduce_op(op)  # Adasum raises here


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
    * gradients are bucket-fused and allreduced with ``op`` /
      ``compression`` (default: ``HVD_COMPRESSION``; the stateless
      ``none`` / ``bf16`` casts are ported); the returned loss is
      averaged across ranks.
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

    The returned loss is a tensor of its own on every call.
    ``step.eager`` is the same step run eagerly, never captured;
    ``step.calls`` counts the calls by kind (``eager``, ``capture``,
    ``replay``).  A step built before :func:`core.reinit` raises on its
    next call.
    """
    del has_batch_stats, autotune_log_file
    if compression is None:
        compression = _compression_from_env()
    _refuse_unported(compression=compression, hierarchical=hierarchical,
                     two_level=two_level, autotune=autotune,
                     profile_guided=profile_guided, profile=profile,
                     donate=donate, op=op)
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

    def _compute_loss(x, y):
        return loss_fn(apply_fn(x), y)

    def _module_buffers() -> List[torch.Tensor]:
        return list(apply_fn.buffers()) if isinstance(apply_fn, nn.Module) \
            else []

    compute_loss = _remat_wrap(_compute_loss, remat, _module_buffers)

    def _reduce_grads(grads):
        return allreduce_pytree(grads, op=op, compression=compression,
                                threshold_bytes=threshold_bytes)

    def _apply_update(state: TrainState, grads) -> TrainState:
        if fused_optimizer:
            params, opt_state = optimizer.fused_update(
                grads, state.opt_state, state.params)
        else:
            updates, opt_state = optimizer.update(
                grads, state.opt_state, state.params)
            apply_updates(state.params, updates)
            params = state.params
        return TrainState(params, opt_state, state.model_state,
                          state.step + 1, state.residual)

    def per_rank_step(state: TrainState, x, y):
        loss = compute_loss(x, y)
        names = list(state.params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [state.params[k] for k in names])))
        grads = _reduce_grads(grads)
        loss = collectives.allreduce(loss.detach(), op=Average)
        return _apply_update(state, grads), loss

    compiled = _CompiledStep(scan_steps(per_rank_step, in_graph_steps),
                             max(in_graph_steps, 1))

    def fetching(run: Callable) -> Callable:
        def call(state: TrainState, x, y):
            state, loss = run(state, x, y)
            fetcher.push(loss)
            return state, loss

        return call

    step = fetching(compiled)
    step.eager = fetching(compiled.eager)
    step.calls = compiled.calls
    step.loss_fetcher = fetcher
    return step


def broadcast_parameters(tree: Dict[str, torch.Tensor],
                         root_rank: int = 0) -> None:
    """``root_rank``'s values into every rank's tensors, in place."""
    with torch.no_grad():
        for t in tree.values():
            collectives.broadcast_(t, root_rank)


def init_train_state(model: nn.Module,
                     optimizer: Union[FusedOptimizer, Transform], *,
                     has_batch_stats: bool = False, compression=None,
                     device=None) -> TrainState:
    """The state of ``model`` on this rank's device: every rank builds
    the model from the same seed, then takes rank 0's parameters and
    statistics (``broadcast_parameters``).  Moves ``model`` to ``device``
    (default :func:`core.device`) and into train mode.  A torch module
    knows its shapes, so the reference's ``sample_input`` is not
    needed."""
    if compression not in (None, Compression.none, Compression.bf16):
        raise _not_ported(f"compression {compression!r}")
    model.to(device if device is not None else core.device()).train()
    params = canonical_params(model)
    model_state = canonical_batch_stats(model) if has_batch_stats else {}
    broadcast_parameters(params)
    broadcast_parameters(model_state)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      model_state=model_state, step=0, residual=())


def shard_batch(batch: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch, on its device: rank ``r``
    takes ``[r·b, (r+1)·b)`` with ``b = len(batch) // size``."""
    n, r = core.size(), core.rank()
    if batch.shape[0] % n:
        raise ValueError(f"global batch {batch.shape[0]} is not divisible "
                         f"by the world size {n}")
    b = batch.shape[0] // n
    return batch[r * b:(r + 1) * b].to(core.device(), non_blocking=True)
