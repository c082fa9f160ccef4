"""Training-loop callbacks: the port of ``horovod_tpu/callbacks.py``
(the reference Horovod's Keras callback set, held against a
``(state, metrics)`` loop).

The learning-rate policies give ``lr(step)`` on the host and, for the
warm-up, :meth:`LearningRateWarmupCallback.as_optax_schedule`: a
schedule of the step count that ``optim.transforms`` evaluates on the
device from its own device count (``scale_by_learning_rate`` with a
callable), so a captured CUDA graph of the step sees every step's rate
instead of freezing the one it was captured with.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import core, eager
from .optim.distributed import broadcast_parameters


class Callback:
    """The protocol: wire into the loop where Keras would call these."""

    def on_train_begin(self, state):  # noqa: B027
        return state

    def on_epoch_end(self, epoch: int, state, metrics: Dict[str, float]):
        return metrics

    def on_batch_end(self, step: int, state):  # noqa: B027
        return state


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the initial state from ``root_rank`` at train start
    (every tensor of the state, in place)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_train_begin(self, state):
        state = broadcast_parameters(state, self.root_rank)
        self.broadcast_done = True
        return state


class MetricAverageCallback(Callback):
    """Average the epoch's metrics over every process before they are
    reported."""

    def on_epoch_end(self, epoch, state, metrics):
        if core.process_size() == 1:
            return dict(metrics)
        gathered = eager.allgather_object(metrics)
        return {k: float(np.mean([m[k] for m in gathered])) for k in metrics}


class LearningRateWarmupCallback(Callback):
    """The rate from ``initial_lr`` to ``initial_lr * multiplier`` over
    ``warmup_epochs`` (Goyal et al.'s linear-scaling warm-up)."""

    def __init__(self, initial_lr: float, multiplier: float,
                 warmup_epochs: float = 5, steps_per_epoch: int = 1,
                 verbose: bool = False):
        self.initial_lr = initial_lr
        self.multiplier = multiplier
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose

    def lr(self, step: int) -> float:
        total = self.warmup_epochs * self.steps_per_epoch
        if step >= total:
            return self.initial_lr * self.multiplier
        frac = step / max(total, 1)
        return self.initial_lr * (1.0 + frac * (self.multiplier - 1.0))

    def as_optax_schedule(self) -> Callable[[Any], torch.Tensor]:
        """``schedule(count) -> rate``, a float32 tensor computed where
        ``count`` lives (the transforms' int32 device count)."""
        total = self.warmup_epochs * self.steps_per_epoch

        def schedule(count):
            count = torch.as_tensor(count)
            frac = torch.clamp_max(count.float() / max(total, 1), 1.0)
            return self.initial_lr * (1.0 + frac * (self.multiplier - 1.0))

        return schedule


class LearningRateScheduleCallback(Callback):
    """A multiplier of ``initial_lr`` over an epoch range."""

    def __init__(self, initial_lr: float, multiplier,
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True, steps_per_epoch: int = 1):
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self.multiplier = (multiplier if callable(multiplier)
                           else (lambda epoch: multiplier))

    def lr(self, step: int) -> float:
        epoch = step / max(self.steps_per_epoch, 1)
        if self.staircase:
            epoch = math.floor(epoch)
        if epoch < self.start_epoch:
            return self.initial_lr
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return self.initial_lr
        return self.initial_lr * self.multiplier(epoch)
