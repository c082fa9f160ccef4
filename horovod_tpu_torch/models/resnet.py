"""ResNet family: the port of ``horovod_tpu/models/resnet.py``.

Same blocks, names and initialization as the flax model: ``BasicBlock``
and ``BottleneckBlock``, the ``"conv"`` stem (7×7 stride-2 conv padded
3, BatchNorm, ReLU, 3×3 stride-2 max pool padded 1), ``conv_proj`` /
``norm_proj`` on shape-changing blocks, the last BatchNorm scale of each
block zero-initialized, and float32 logits.  Submodules carry the flax
module names (``conv_init``, ``BottleneckBlock_3``, ``Conv_1``,
``Dense_0``...) so ``convert.py`` maps parameters by name.

Layout and precision: the public input is NHWC like the reference's.
Inside, ``permute`` makes it an NCHW tensor whose memory is still NHWC —
PyTorch's ``channels_last`` — with no copy.  Parameters are float32;
``dtype=torch.bfloat16`` (the default, as in the reference) computes
under ``torch.autocast``.

The ``space_to_depth`` stem and the Pallas variants (``norm_act``,
``residual_join``, ``conv_bn`` set to ``"pallas"``) are later slices and
raise ``NotImplementedError``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = Conv(in_features, filters, 1, generator=generator)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides, generator=generator)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, 1, generator=generator)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if in_features != out or strides != 1:
            self.conv_proj = Conv(in_features, out, 1, strides,
                                  generator=generator)
            self.norm_proj = BatchNorm(out)

    def forward(self, x):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, 3, strides,
                           generator=generator)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, generator=generator)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if in_features != filters or strides != 1:
            self.conv_proj = Conv(in_features, filters, 1, strides,
                                  generator=generator)
            self.norm_proj = BatchNorm(filters)

    def forward(self, x):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


def _later_slice(option: str, value: str, valid: Sequence[str]) -> None:
    if value == valid[0]:
        return
    if value in valid:
        raise NotImplementedError(
            f"ResNet({option}={value!r}) is not ported yet: the TPU "
            "variants come with their kernels in a later slice")
    raise ValueError(f"unknown {option} {value!r} (want one of {valid})")


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, stem: str = "conv",
                 residual_join: str = "xla", conv_bn: str = "xla",
                 norm_act: str = "xla", in_features: int = 3, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _later_slice("stem", stem, ("conv", "space_to_depth"))
        _later_slice("residual_join", residual_join, ("xla", "pallas"))
        _later_slice("conv_bn", conv_bn, ("xla", "pallas"))
        _later_slice("norm_act", norm_act, ("xla", "pallas"))
        self.dtype = dtype
        self.conv_init = Conv(in_features, num_filters, 7, 2,
                              padding=((3, 3), (3, 3)), generator=generator)
        self.bn_init = BatchNorm(num_filters)
        width = num_filters
        k = 0
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = 2 if i > 0 and j == 0 else 1
                block = block_cls(width, num_filters * 2 ** i, strides,
                                  generator=generator)
                self.add_module(f"{block_cls.__name__}_{k}", block)
                width = num_filters * 2 ** i * block_cls.expansion
                k += 1
        self.num_blocks = k
        self.block_name = block_cls.__name__
        self.Dense_0 = Dense(width, num_classes, generator=generator)

    def forward(self, x):
        """``x``: ``[batch, height, width, channels]``; returns float32
        logits ``[batch, num_classes]``."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            x = F.relu(self.bn_init(self.conv_init(x)))
            x = F.max_pool2d(x, 3, 2, padding=1)
            for k in range(self.num_blocks):
                x = getattr(self, f"{self.block_name}_{k}")(x)
            x = self.Dense_0(x.mean(dim=(2, 3)))
        return x.float()


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)

MODELS = {
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
}
