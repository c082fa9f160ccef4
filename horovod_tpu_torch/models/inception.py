"""Inception V3: the port of ``horovod_tpu/models/inception.py``.

Inception V3 heads the reference's published scaling table.  Same blocks,
names and initialization as the flax model: :class:`ConvBN` (a bias-free
conv, BatchNorm at epsilon 1e-3 and momentum 0.9, ReLU) and blocks A-E,
each block's ``ConvBN_k`` numbered in the order the flax block calls
them, so ``convert.canonical_params`` lists the leaves as
``jax.tree_util`` does (``InceptionE_0/ConvBN_3/Conv_0/kernel``).

What flax does that torch does not by default:

* ``"SAME"`` convs pad per call from the input size (``layers.Conv``);
  the stride-2 convs and three of the stem's are ``"VALID"``;
* the 3×3 stride-1 ``"SAME"`` average pool of the pool branches counts
  the padding (``count_include_pad``);
* ``max_pool`` pads ``"VALID"``.

Layout and precision as in ``resnet.py``: NHWC input viewed as NCHW over
channels-last memory, float32 parameters, ``dtype`` (bf16 by default)
under ``torch.autocast``, float32 logits.  The input is 299×299 (any size
of at least 75).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense

Kernel = Union[int, Tuple[int, int]]


class ConvBN(nn.Module):
    """conv + BN + ReLU, the Inception building block."""

    def __init__(self, in_features: int, features: int,
                 kernel: Kernel = 3, strides: int = 1,
                 padding: str = "SAME", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           generator=generator)
        self.BatchNorm_0 = BatchNorm(features, epsilon=1e-3)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """A block of ConvBNs numbered in the order they are made, which is
    the order the flax block calls them."""

    def _convs(self, generator):
        """``conv(in, out, kernel, **kw) -> out``, which adds the next
        ``ConvBN_k``."""
        def conv(in_features: int, features: int, kernel: Kernel,
                 **kw) -> int:
            self.add_module(f"ConvBN_{len(self._modules)}", ConvBN(
                in_features, features, kernel, generator=generator, **kw))
            return features

        return conv

    def _run(self, first: int, last: int, x):
        """ConvBN_first .. ConvBN_last in sequence."""
        for k in range(first, last + 1):
            x = getattr(self, f"ConvBN_{k}")(x)
        return x


class InceptionA(_Block):
    def __init__(self, in_features: int, pool_features: int, *,
                 generator=None):
        super().__init__()
        c = self._convs(generator)
        c(in_features, 64, 1)
        c(c(in_features, 48, 1), 64, 5)
        c(c(c(in_features, 64, 1), 96, 3), 96, 3)
        c(in_features, pool_features, 1)
        self.features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([self._run(0, 0, x), self._run(1, 2, x),
                          self._run(3, 5, x),
                          self._run(6, 6, _avg_pool_same(x))], dim=1)


class InceptionB(_Block):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, in_features: int, *, generator=None):
        super().__init__()
        c = self._convs(generator)
        c(in_features, 384, 3, strides=2, padding="VALID")
        c(c(c(in_features, 64, 1), 96, 3), 96, 3, strides=2,
          padding="VALID")
        self.features = 384 + 96 + in_features

    def forward(self, x):
        return torch.cat([self._run(0, 0, x), self._run(1, 3, x),
                          _max_pool(x)], dim=1)


class InceptionC(_Block):
    """Factorized 7x7 branches (1x7 / 7x1)."""

    def __init__(self, in_features: int, c7: int, *, generator=None):
        super().__init__()
        c = self._convs(generator)
        c(in_features, 192, 1)
        c(c(c(in_features, c7, 1), c7, (1, 7)), 192, (7, 1))
        c(c(c(c(c(in_features, c7, 1), c7, (7, 1)), c7, (1, 7)), c7, (7, 1)),
          192, (1, 7))
        c(in_features, 192, 1)
        self.features = 4 * 192

    def forward(self, x):
        return torch.cat([self._run(0, 0, x), self._run(1, 3, x),
                          self._run(4, 8, x),
                          self._run(9, 9, _avg_pool_same(x))], dim=1)


class InceptionD(_Block):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, in_features: int, *, generator=None):
        super().__init__()
        c = self._convs(generator)
        c(c(in_features, 192, 1), 320, 3, strides=2, padding="VALID")
        c(c(c(c(in_features, 192, 1), 192, (1, 7)), 192, (7, 1)), 192, 3,
          strides=2, padding="VALID")
        self.features = 320 + 192 + in_features

    def forward(self, x):
        return torch.cat([self._run(0, 1, x), self._run(2, 5, x),
                          _max_pool(x)], dim=1)


class InceptionE(_Block):
    """Expanded filter banks (split 1x3 / 3x1 outputs concatenated)."""

    def __init__(self, in_features: int, *, generator=None):
        super().__init__()
        c = self._convs(generator)
        c(in_features, 320, 1)
        c(in_features, 384, 1)
        c(384, 384, (1, 3))
        c(384, 384, (3, 1))
        c(c(in_features, 448, 1), 384, 3)
        c(384, 384, (1, 3))
        c(384, 384, (3, 1))
        c(in_features, 192, 1)
        self.features = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b3 = self._run(1, 1, x)
        bd = self._run(4, 5, x)
        return torch.cat([self._run(0, 0, x),
                          self._run(2, 2, b3), self._run(3, 3, b3),
                          self._run(6, 6, bd), self._run(7, 7, bd),
                          self._run(8, 8, _avg_pool_same(x))], dim=1)


class InceptionV3(nn.Module):
    #: the smallest input the stem's VALID convs and pools take
    MIN_SIZE = 75

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 299,
                 in_features: int = 3, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size < self.MIN_SIZE:
            raise ValueError(f"InceptionV3 takes images of at least "
                             f"{self.MIN_SIZE}x{self.MIN_SIZE}, got "
                             f"{image_size}")
        self.dtype = dtype
        stem = ((32, 3, 2, "VALID"), (32, 3, 1, "VALID"), (64, 3, 1, "SAME"),
                (80, 1, 1, "VALID"), (192, 3, 1, "VALID"))
        width = in_features
        for k, (features, kernel, strides, padding) in enumerate(stem):
            self.add_module(f"ConvBN_{k}", ConvBN(
                width, features, kernel, strides, padding,
                generator=generator))
            width = features
        blocks = [("InceptionA_0", InceptionA, {"pool_features": 32}),
                  ("InceptionA_1", InceptionA, {"pool_features": 64}),
                  ("InceptionA_2", InceptionA, {"pool_features": 64}),
                  ("InceptionB_0", InceptionB, {}),
                  ("InceptionC_0", InceptionC, {"c7": 128}),
                  ("InceptionC_1", InceptionC, {"c7": 160}),
                  ("InceptionC_2", InceptionC, {"c7": 160}),
                  ("InceptionC_3", InceptionC, {"c7": 192}),
                  ("InceptionD_0", InceptionD, {}),
                  ("InceptionE_0", InceptionE, {}),
                  ("InceptionE_1", InceptionE, {})]
        self.block_names = [name for name, _, _ in blocks]
        for name, cls, kw in blocks:
            block = cls(width, generator=generator, **kw)
            self.add_module(name, block)
            width = block.features
        self.Dense_0 = Dense(width, num_classes, generator=generator)

    def forward(self, x):
        """``x``: ``[batch, height, width, channels]``; returns float32
        logits ``[batch, num_classes]``."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            # stem: 299 -> 35x35x192
            x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
            x = self.ConvBN_4(self.ConvBN_3(_max_pool(x)))
            x = _max_pool(x)
            for name in self.block_names:
                x = getattr(self, name)(x)
            x = self.Dense_0(x.mean(dim=(2, 3)))
        return x.float()
