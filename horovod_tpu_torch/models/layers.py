"""The flax ``linen`` layers the models use, as ``nn.Module``s that
compute what flax computes.

* :class:`Conv` — ``nn.Conv``, without bias unless ``use_bias``,
  ``"SAME"`` padding by default (``"VALID"`` or explicit pairs too).
  XLA pads SAME asymmetrically when the padding is odd: a stride-2 3×3
  conv over an even input pads ``(0, 1)``, where ``nn.Conv2d(padding=1)``
  would pad ``(1, 1)`` and shift every output by
  one pixel, so the padding is computed per call from the input size.
* :class:`BatchNorm` — ``nn.BatchNorm`` with flax's statistics: the
  running averages blend by ``momentum=0.9`` as ``ra = 0.9·ra +
  0.1·batch`` (torch's ``momentum=0.1``), and the running variance takes
  the *biased* batch variance, where ``nn.BatchNorm2d`` takes the
  unbiased one.  The statistics are this replica's own (not synced
  across ranks), as in the reference.
* :class:`Dense` — ``nn.Dense``; with ``dtype`` set it computes in that
  dtype, casting input, kernel and bias as flax's ``promote_dtype`` does.
* :class:`DenseGeneral` — ``nn.DenseGeneral`` from trailing input axes
  to an output shape (the attention projections).
* :class:`Embed` — ``nn.Embed``: lookup, and :meth:`Embed.attend` for a
  tied output head.
* :class:`LayerNorm` — ``nn.LayerNorm`` with flax's defaults, which are
  not torch's: epsilon 1e-6 and the fast variance ``E[x²] − E[x]²``
  clamped at 0, statistics in (at least) float32, output in ``dtype``.

Kernels are initialized like flax's ``lecun_normal`` (a normal truncated
at two standard deviations, variance ``1/fan_in``), embeddings like its
``variance_scaling(1, "fan_in", "normal", out_axis=0)`` (a plain normal
of variance ``1/features``), from an explicit ``torch.Generator``.
Parameters keep torch's layouts (OIHW convs, ``[out, in]`` linears, and
``[prod(out), prod(in)]`` for :class:`DenseGeneral`); ``convert.py``
maps them to flax's.
"""

from __future__ import annotations

import math
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
    """flax ``nn.Conv``: a lecun-normal kernel and, with ``use_bias``, a
    zero bias (flax's default has one; the ResNets and Inception pass
    ``use_bias=False``).  ``kernel_size`` and ``strides`` are an int or an
    (h, w) pair; ``padding`` is ``"SAME"``, ``"VALID"`` or explicit
    ``((top, bottom), (left, right))``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 *, use_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, kernel_size, stride=strides,
                         padding=0, bias=use_bias)
        self.same = padding == "SAME"
        if padding == "VALID":
            padding = ((0, 0), (0, 0))
        self.pads = None if self.same else tuple(map(tuple, padding))
        lecun_normal_(self.weight, generator)
        if use_bias:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        if self.same:
            (t, b), (l, r) = (
                same_padding(x.shape[d], self.kernel_size[i], self.stride[i])
                for i, d in enumerate((2, 3)))
        else:
            (t, b), (l, r) = self.pads
        if t == b and l == r:
            return F.conv2d(x, self.weight, self.bias, self.stride, (t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), self.weight, self.bias,
                        self.stride)


class Dense(nn.Linear):
    """flax ``nn.Dense``: lecun-normal kernel, zero bias.  ``dtype=None``
    leaves the dtype to the caller (the ResNet and MLP run it under
    autocast)."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features)
        self.dtype = dtype
        lecun_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        if self.dtype is None:
            return super().forward(x)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral``: contracts the trailing ``in_shape`` axes
    into ``out_shape`` in ``dtype``.  The kernel is kept as a linear
    ``weight [prod(out_shape), prod(in_shape)]`` and the bias as
    ``[prod(out_shape)]``; flax's are ``in_shape + out_shape`` and
    ``out_shape``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(math.prod(self.out_shape),
                                               math.prod(self.in_shape)))
        self.bias = nn.Parameter(torch.zeros(math.prod(self.out_shape)))
        lecun_normal_(self.weight, generator)

    def forward(self, x):
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = F.linear(x.reshape(*lead, -1).to(self.dtype),
                     self.weight.to(self.dtype), self.bias.to(self.dtype))
        return y.reshape(*lead, *self.out_shape)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``weight [num_embeddings, features]`` (flax's
    ``embedding``, same layout)."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        with torch.no_grad():
            self.weight.normal_(0.0, (1.0 / features) ** 0.5,
                                generator=generator)

    def forward(self, ids):
        # gather, then cast: the same values as flax's cast-then-take
        return F.embedding(ids, self.weight).to(self.dtype)

    def attend(self, query):
        """``query · embeddingᵀ`` with both promoted to ``dtype``, as
        flax's ``promote_dtype`` does: a tied head in bf16."""
        return torch.matmul(query.to(self.dtype),
                            self.weight.to(self.dtype).t())


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last dim, in flax's arithmetic:
    ``mul = rsqrt(var + eps) · scale;  y = (x − mean) · mul + bias``."""

    def __init__(self, features: int, *, epsilon: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xs.mean(-1, keepdim=True)
        var = torch.clamp_min((xs * xs).mean(-1, keepdim=True)
                              - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    dim of NCHW input (Inception's ``epsilon=1e-3``).  ``zero_scale`` is
    the zero-initialized scale of each residual block's last norm."""

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
