"""Distributed optimizer wrappers: the port of
``horovod_tpu/optim/distributed.py``.

* :func:`DistributedOptimizer` — wraps a transform of
  ``optim.transforms`` (an optax-style ``init`` / ``update`` pair) so its
  updates see the job's reduced gradients: fused and compressed by
  ``allreduce_pytree``, Adasum leaf by leaf, error feedback with the
  residual in the optimizer's state, and ``backward_passes_per_step``
  local accumulation between reductions.
* :class:`DistributedGradientTape` and :func:`grad` — a gradient
  function whose output is allreduced.
* :func:`broadcast_parameters` / :func:`broadcast_optimizer_state` /
  :func:`broadcast_variables` — ``root_rank``'s values into every
  rank's tensors, in place.

Like the transforms, the wrapper updates its state's tensors in place.
The accumulation counter is a host integer: whether a call reduces is
decided on the host, as the reference's ``lax.cond`` decides inside its
program, so under a CUDA graph only ``backward_passes_per_step=1``
captures (the branch taken at capture would be replayed every step).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import core
from ..core import Adasum, Average
from ..ops import collectives
from ..ops.compression import Compression, ErrorFeedback
from ..ops.fusion import allreduce_pytree
from ..ops.sparse import densify_tree
from ..utils.tree import tree_flatten, tree_unflatten
from .transforms import Transform, _assign, _zeros_like


class _AccumulationState(NamedTuple):
    inner: Any
    counter: list                 # [backward passes since the last sync]
    accum: Any                    # the gradients accumulated since


class _ErrorFeedbackState(NamedTuple):
    """The error-feedback residual in the optimizer's state, so it is
    broadcast and saved with the rest of it."""

    inner: Any
    residual: Any


def DistributedOptimizer(optimizer: Transform, *, op: str = Average,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         process_set: Optional[collectives.ProcessSet] = None,
                         threshold_bytes: Optional[int] = None,
                         sparse_as_dense: bool = False) -> Transform:
    """``optimizer`` with its incoming gradients reduced across the job.

    With ``backward_passes_per_step`` n > 1 the gradients accumulate
    locally and the reduction (of their mean) runs every nth update;
    the updates in between are zeros (the parameters hold still).  An
    :class:`ErrorFeedback` ``compression`` keeps its residual in the
    state, zero at ``init`` and updated by every reduction."""
    n = int(backward_passes_per_step)
    if n < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    ef = isinstance(compression, ErrorFeedback)
    if ef and op == Adasum:
        raise ValueError(
            "error-feedback compression composes with Sum/Average "
            "allreduce, not Adasum (the scale-invariant merge is not "
            "linear in the residual)")

    def reduce_grads(grads, residual=None):
        """``(reduced, new_residual)``; the residual is None without
        error feedback, else updated in place."""
        if op == Adasum:
            # Adasum has no sparse form: densify first
            leaves, treedef = tree_flatten(densify_tree(grads))
            return tree_unflatten(treedef, [
                collectives.allreduce(g, op=Adasum) for g in leaves]), None
        reduced = allreduce_pytree(
            grads, op=op, compression=compression, process_set=process_set,
            threshold_bytes=threshold_bytes, sparse_as_dense=sparse_as_dense,
            residual=residual)
        if residual is not None:
            reduced, new = reduced
            with torch.no_grad():
                _assign(residual, new)
        # the transforms take dense tensors: the communication was
        # sparse, the application is a scatter-add
        return densify_tree(reduced), residual

    def inner_init(params):
        inner = optimizer.init(params)
        if ef:
            return _ErrorFeedbackState(inner, ErrorFeedback.init_state(params))
        return inner

    def reduce_and_update(grads, state, params, **extra):
        if ef:
            reduced, _ = reduce_grads(densify_tree(grads), state.residual)
            updates, _ = optimizer.update(reduced, state.inner, params,
                                          **extra)
            return updates
        reduced, _ = reduce_grads(grads)
        return optimizer.update(reduced, state, params, **extra)[0]

    if n == 1:
        def update_fn(grads, state, params=None, **extra):
            return reduce_and_update(grads, state, params, **extra), state

        return Transform(inner_init, update_fn)

    def init_fn(params):
        return _AccumulationState(inner=inner_init(params), counter=[0],
                                  accum=_zeros_like(params))

    def update_acc(grads, state, params=None, **extra):
        grads = densify_tree(grads)
        with torch.no_grad():
            for a, g in zip(tree_flatten(state.accum)[0],
                            tree_flatten(grads)[0]):
                a.add_(g)
        state.counter[0] += 1
        if state.counter[0] < n:
            return _zeros_like(grads), state
        leaves, treedef = tree_flatten(state.accum)
        mean = tree_unflatten(treedef, [a / n for a in leaves])
        updates = reduce_and_update(mean, state.inner, params, **extra)
        with torch.no_grad():
            for a in leaves:
                a.zero_()
        state.counter[0] = 0
        return updates, state

    return Transform(init_fn, update_acc)


class DistributedGradientTape:
    """A gradient function whose gradients are allreduced (the
    reference's stand-in for TF2's ``hvd.DistributedGradientTape``)::

        tape = DistributedGradientTape(grad(loss_fn))
        grads = tape.gradient(params, batch)
    """

    def __init__(self, grad_fn: Callable, *, op: str = Average,
                 compression=Compression.none,
                 process_set: Optional[collectives.ProcessSet] = None):
        self._grad_fn = grad_fn
        self._op = op
        self._compression = compression
        self._process_set = process_set

    def gradient(self, *args, **kwargs):
        return allreduce_pytree(
            self._grad_fn(*args, **kwargs), op=self._op,
            compression=self._compression, process_set=self._process_set)

    def __call__(self, *args, **kwargs):
        return self.gradient(*args, **kwargs)


def _local_grad(fun: Callable) -> Callable:
    """``jax.grad``'s counterpart: the gradient of the scalar
    ``fun(params, *args)`` with respect to the tensors of ``params``."""
    def gf(params, *args, **kwargs):
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = fun(tree_unflatten(treedef, leaves), *args, **kwargs)
        return tree_unflatten(treedef, list(torch.autograd.grad(loss,
                                                                leaves)))

    return gf


def grad(fun: Callable, *, op: str = Average,
         compression=Compression.none) -> Callable:
    """``grad(fun)(params, *args)``: the gradient of ``fun`` with respect
    to ``params`` (a dict of tensors), allreduced."""
    gf = _local_grad(fun)

    def wrapped(*args, **kwargs):
        return allreduce_pytree(gf(*args, **kwargs), op=op,
                                compression=compression)

    return wrapped


def broadcast_parameters(params, root_rank: int = 0):
    """``root_rank``'s values into every rank's tensors of ``params``
    (any tree of tensors; other leaves are left alone), in place;
    returns ``params``."""
    core._require_init()
    if core.process_size() == 1:
        return params
    with torch.no_grad():
        for t in tree_flatten(params)[0]:
            if torch.is_tensor(t):
                collectives.broadcast_(t, root_rank)
    return params


def broadcast_optimizer_state(opt_state, root_rank: int = 0):
    """The same for an optimizer's state."""
    return broadcast_parameters(opt_state, root_rank)


def broadcast_variables(variables, root_rank: int = 0):
    """The TensorFlow-flavoured name of :func:`broadcast_parameters`."""
    return broadcast_parameters(variables, root_rank)
