"""Data-parallel training step builder: the port of
``horovod_tpu/training.py``.

Every rank runs the same step on its shard of the global batch: forward
and backward through the model, one fused allreduce of the gradients
(``ops/fusion.py``), the loss averaged across ranks for reporting, and
the optimizer update — the flat fused kernel K1 for a
:class:`~horovod_tpu_torch.optim.fused_update.FusedOptimizer`.  The
step's blocks are kept as separate functions, as the reference keeps
them for its profiler.

Where the reference returns a new state from a jitted, donating step,
the port updates the state in place: the model's parameters, its
BatchNorm statistics and the optimizer's flat buffers are the tensors of
the :class:`TrainState`.  ``in_graph_steps`` is a plain Python loop of
``k`` steps per call (a CUDA graph is later work).

Knobs whose slice has not landed yet (error-feedback compression,
``two_level``, ``hierarchical``, ``autotune``, ``profile_guided``,
``profile``, ``remat_policy``, and their ``HVD_*`` environment
defaults) raise ``NotImplementedError``; none is silently ignored.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from . import core
from .convert import canonical_batch_stats, canonical_params
from .core import Average
from .ops import collectives
from .ops.compression import Compression, from_env as _compression_from_env
from .ops.fusion import allreduce_pytree
from .optim.fused_update import FusedOptimizer, apply_updates
from .utils import env as env_util


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
    the last step's loss.  ``k <= 1``: identity."""
    if k <= 1:
        return step_fn

    def looped(state, *args):
        for _ in range(k):
            state, loss = step_fn(state, *args)
        return state, loss

    return looped


def _not_ported(knob: str) -> NotImplementedError:
    return NotImplementedError(
        f"make_train_step: {knob} is not ported yet (it lands with a later "
        "slice of horovod_tpu_torch)")


def _refuse_unported(*, compression, hierarchical, two_level, autotune,
                     profile_guided, profile, remat_policy, donate, op):
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
    if remat_policy is None:
        remat_policy = env_util.get_str(env_util.HVD_REMAT_POLICY)
    if remat_policy not in (None, "", "none"):
        raise _not_ported(f"remat_policy={remat_policy!r}")
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
    optimizer: FusedOptimizer,
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
    """Returns ``step(state, x, y) -> (state, loss)``.

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
    * ``fused_optimizer`` (default ``HVD_FUSED_OPTIMIZER``, on) routes
      the update through the flat fused kernel instead of the per-leaf
      traversal; both share one flat state.
    * ``loss_fetch_steps`` (default ``HVD_LOSS_FETCH_STEPS``, 16) drives
      ``step.loss_fetcher``.
    """
    del has_batch_stats, autotune_log_file
    if compression is None:
        compression = _compression_from_env()
    _refuse_unported(compression=compression, hierarchical=hierarchical,
                     two_level=two_level, autotune=autotune,
                     profile_guided=profile_guided, profile=profile,
                     remat_policy=remat_policy, donate=donate, op=op)
    if not isinstance(optimizer, FusedOptimizer):
        raise TypeError(
            "the port's train step takes a FusedOptimizer (fused_sgd / "
            f"fused_adam), got {type(optimizer).__name__}")
    if fused_optimizer is None:
        fused_optimizer = env_util.get_bool(env_util.HVD_FUSED_OPTIMIZER,
                                            True)
    if loss_fetch_steps is None:
        loss_fetch_steps = env_util.get_int(
            env_util.HVD_LOSS_FETCH_STEPS, env_util.DEFAULT_LOSS_FETCH_STEPS)
    fetcher = TrailingLossFetcher(loss_fetch_steps)

    def _compute_loss(x, y):
        return loss_fn(apply_fn(x), y)

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
        loss = _compute_loss(x, y)
        names = list(state.params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [state.params[k] for k in names])))
        grads = _reduce_grads(grads)
        loss = collectives.allreduce(loss.detach(), op=Average)
        return _apply_update(state, grads), loss

    per_rank_entry = scan_steps(per_rank_step, in_graph_steps)

    def step(state: TrainState, x, y):
        state, loss = per_rank_entry(state, x, y)
        fetcher.push(loss)
        return state, loss

    step.loss_fetcher = fetcher
    return step


def broadcast_parameters(tree: Dict[str, torch.Tensor],
                         root_rank: int = 0) -> None:
    """``root_rank``'s values into every rank's tensors, in place."""
    with torch.no_grad():
        for t in tree.values():
            collectives.broadcast_(t, root_rank)


def init_train_state(model: nn.Module, optimizer: FusedOptimizer, *,
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
