"""The optax transforms the JAX package's entry points train with, for
the per-leaf path of the train step.

The reference's benchmarks hand ``make_train_step`` an optax optimizer
(``optax.sgd(0.01, momentum=0.9)`` in the image bench, ``optax.adamw(1e-4)``
in the BERT bench), which it runs leaf by leaf: ``optimizer.update`` and
``optax.apply_updates``.  This module holds those optimizers as optax
builds them, each an ``init``/``update`` pair (:class:`Transform`) chained
from the same pieces, in the same order and with the same expressions:

* ``sgd(lr, momentum)`` — ``trace(momentum)`` (``t = g + m·t``), then
  ``scale_by_learning_rate`` (``−lr · u``); with no momentum the scale
  alone;
* ``adam(lr, b1, b2, eps)`` — ``scale_by_adam`` (``μ = (1−b1)·g + b1·μ``,
  ``ν = (1−b2)·g² + b2·ν``, ``μ / (1 − b1^t)`` over ``√(ν / (1 − b2^t) +
  eps_root) + eps``), then the scale;
* ``adamw(lr, ..., weight_decay=1e-4)`` — ``scale_by_adam``, then
  ``add_decayed_weights`` (``u + wd·p`` on every leaf, optax's
  ``mask=None``), then the scale.

A callable learning rate is a schedule of the step count
(``scale_by_schedule``), evaluated on the device from an int32 device
count, as ``callbacks.LearningRateWarmupCallback.as_optax_schedule``
gives one.

The states are optax's (``TraceState``, ``ScaleByAdamState``,
``EmptyState`` and a tuple for a chain) with one difference: ``update``
writes the new moments and count into the state's own tensors, in place,
as the fused optimizer does, so a CUDA graph of the step stays bound to
them.  The step count is an int32 scalar on the parameters' device and
the bias corrections are computed from it there, in float32 (optax's
``1 − decay**count``), then cast to each moment's type: nothing the graph
freezes at capture changes from step to step.  The moments take each
leaf's own type, as optax's ``zeros_like`` does.

Plain torch ops, leaf by leaf: the JAX package has no fused form of these
(its flat kernel K1 serves :mod:`.fused_update`), and this module adds
none.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..utils.tree import tree_flatten, tree_unflatten
from .fused_update import apply_updates  # noqa: F401  (optax.apply_updates)


class Transform(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state`` and
    ``update(updates, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class TraceState(NamedTuple):
    trace: Any


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar, on the parameters' device
    mu: Any
    nu: Any


def _zeros_like(params):
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [torch.zeros_like(p) for p in leaves])


def _map(fn, *trees):
    leaves = [tree_flatten(t)[0] for t in trees]
    return tree_unflatten(tree_flatten(trees[0])[1],
                          [fn(*xs) for xs in zip(*leaves)])


def _assign(dst_tree, src_tree) -> None:
    for dst, src in zip(tree_flatten(dst_tree)[0], tree_flatten(src_tree)[0]):
        dst.copy_(src)


def _device_of(params) -> torch.device:
    leaves = tree_flatten(params)[0]
    return leaves[0].device if leaves else torch.device("cpu")


def trace(decay: float) -> Transform:
    """optax ``trace(decay)``: ``t = g + decay·t``; the update is ``t``."""
    def init(params):
        return TraceState(trace=_zeros_like(params))

    def update(updates, state, params=None):
        del params
        with torch.no_grad():
            new = _map(lambda g, t: g + decay * t, updates, state.trace)
            _assign(state.trace, new)
        return new, state

    return Transform(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> Transform:
    """optax ``scale_by_adam``: the moments in each leaf's type, the
    bias corrections ``1 − b**count`` in float32 on the device."""
    def init(params):
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32,
                              device=_device_of(params)),
            mu=_zeros_like(params), nu=_zeros_like(params))

    def update(updates, state, params=None):
        del params
        with torch.no_grad():
            mu = _map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
            nu = _map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates,
                      state.nu)
            state.count.add_(1)
            c = state.count.float()
            bc1, bc2 = 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)
            new = _map(lambda m, v: (m / bc1.to(m.dtype)) / (
                torch.sqrt(v / bc2.to(v.dtype) + eps_root) + eps), mu, nu)
            _assign(state.mu, mu)
            _assign(state.nu, nu)
        return new, state

    return Transform(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> Transform:
    """optax ``add_decayed_weights(weight_decay, mask=None)``: ``u +
    wd·p`` on every leaf."""
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        with torch.no_grad():
            return _map(lambda g, p: g + weight_decay * p, updates,
                        params), state

    return Transform(lambda params: EmptyState(), update)


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32 scalar, on the parameters' device


def scale_by_schedule(step_size_fn: Callable) -> Transform:
    """optax ``scale_by_schedule``: ``step_size_fn(count)·u``, the
    schedule evaluated on the device from the int32 device count (so a
    captured graph sees each step's value), then the count advanced."""
    def init(params):
        return ScaleByScheduleState(count=torch.zeros(
            (), dtype=torch.int32, device=_device_of(params)))

    def update(updates, state, params=None):
        del params
        with torch.no_grad():
            step_size = torch.as_tensor(step_size_fn(state.count))
            new = _map(lambda g: step_size.to(g.dtype) * g, updates)
            state.count.add_(1)
        return new, state

    return Transform(init, update)


def scale_by_learning_rate(learning_rate) -> Transform:
    """optax ``scale_by_learning_rate``: ``(−lr)·u``; a callable
    ``learning_rate`` is a schedule of the step count
    (:func:`scale_by_schedule` of ``−lr(count)``)."""
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -1 * learning_rate(count))
    step_size = -1 * learning_rate

    def update(updates, state, params=None):
        del params
        with torch.no_grad():
            return _map(lambda g: step_size * g, updates), state

    return Transform(lambda params: EmptyState(), update)


def chain(*transforms: Transform) -> Transform:
    """optax ``chain``: each transform's update feeds the next; the state
    is the tuple of theirs."""
    def init(params) -> Tuple:
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        for t, s in zip(transforms, state):
            updates, _ = t.update(updates, s, params)
        return updates, state

    return Transform(init, update)


def sgd(learning_rate, momentum: float = None) -> Transform:
    """optax ``sgd(learning_rate, momentum)``."""
    if momentum is None:
        return scale_by_learning_rate(learning_rate)
    return chain(trace(momentum), scale_by_learning_rate(learning_rate))


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Transform:
    """optax ``adam``."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> Transform:
    """optax ``adamw`` with ``mask=None``: the decay on every leaf."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))
