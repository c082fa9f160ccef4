"""The flax ``linen`` layers the models use, as ``nn.Module``s that
compute what flax computes.

* :class:`Conv` — ``nn.Conv`` without bias, ``"SAME"`` padding by
  default.  XLA pads SAME asymmetrically when the padding is odd: a
  stride-2 3×3 conv over an even input pads ``(0, 1)``, where
  ``nn.Conv2d(padding=1)`` would pad ``(1, 1)`` and shift every output by
  one pixel, so the padding is computed per call from the input size.
* :class:`BatchNorm` — ``nn.BatchNorm`` with flax's statistics: the
  running averages blend by ``momentum=0.9`` as ``ra = 0.9·ra +
  0.1·batch`` (torch's ``momentum=0.1``), and the running variance takes
  the *biased* batch variance, where ``nn.BatchNorm2d`` takes the
  unbiased one.  The statistics are this replica's own (not synced
  across ranks), as in the reference.
* :class:`Dense` — ``nn.Dense``.

Kernels are initialized like flax's ``lecun_normal`` (a normal truncated
at two standard deviations, variance ``1/fan_in``), from an explicit
``torch.Generator``.  Parameters keep torch's layouts (OIHW convs,
``[out, in]`` linears); ``convert.py`` maps them to flax's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# stddev of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator]) -> None:
    fan_in = weight[0].numel()
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding ``(low, high)`` of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv(use_bias=False)``; ``padding`` is ``"SAME"`` or
    explicit ``((top, bottom), (left, right))``."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 *, generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, kernel_size, stride=strides,
                         padding=0, bias=False)
        self.same = padding == "SAME"
        self.pads = None if self.same else tuple(map(tuple, padding))
        lecun_normal_(self.weight, generator)

    def forward(self, x):
        if self.same:
            (t, b), (l, r) = (
                same_padding(x.shape[d], self.kernel_size[i], self.stride[i])
                for i, d in enumerate((2, 3)))
        else:
            (t, b), (l, r) = self.pads
        if t == b and l == r:
            return F.conv2d(x, self.weight, None, self.stride, (t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), self.weight, None,
                        self.stride)


class Dense(nn.Linear):
    """flax ``nn.Dense``: lecun-normal kernel, zero bias."""

    def __init__(self, in_features: int, features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features)
        lecun_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    dim of NCHW input.  ``zero_scale`` is the zero-initialized scale of
    each residual block's last norm."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.zeros(features) if zero_scale
                                   else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        # One cuDNN pass normalizes with the batch statistics and, with
        # momentum 1, leaves them in the scratch buffers: the mean, and
        # the variance with Bessel's correction, which is undone below.
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.epsilon)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            # In place: the running statistics are this module's state.
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(
                m * self.running_var + (1 - m) * (var * ((n - 1) / n)))
        return y
