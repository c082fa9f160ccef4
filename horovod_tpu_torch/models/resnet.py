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

The reference's options are all here:

* ``stem="space_to_depth"`` — :class:`SpaceToDepthConvInit`, the 7×7
  stride-2 stem as a 4×4 stride-1 conv over the space-to-depth input,
  from the same 7×7 kernel parameter;
* ``norm_act="pallas"`` — every BatchNorm→ReLU pair becomes
  :class:`BatchNormReLU` (statistics in float32 torch ops, the
  normalize+activate pass K6, its backward K6′);
* ``residual_join="pallas"`` — each block's ``relu(residual + y)`` is K7
  (backward K6′);
* ``conv_bn="pallas"`` — the 3×3 conv + BatchNorm + ReLU of each stride-1
  block becomes :class:`PallasConvBN3x3` (train: K9 forward, K10 for dx
  backward; eval: K8).  Stride-2 blocks keep the plain pair, and in
  ``BasicBlock`` only the first 3×3 is fused.

The options rename a block's modules as flax's per-class counters do
(``BatchNormReLU_0``, ``PallasConvBN3x3_0``, a ``BatchNorm_0`` in place of
``BatchNorm_2``, ``Conv_1`` for the expansion where the 3×3 is fused), so
checkpoints interchange with the reference's model of the same options,
not with the plain model's.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_bn import conv3x3_bn_relu, conv3x3_bn_relu_train
from ..ops.elementwise import autocast_off, residual_relu, scale_bias_relu
from .layers import BatchNorm, Conv, Dense, lecun_normal_


class SpaceToDepthConvInit(nn.Module):
    """The stem's 7×7 stride-2 conv computed as a 4×4 stride-1 conv over
    the space-to-depth (2) input: the same output, from the same
    ``weight`` (flax's ``kernel`` ``[7, 7, Cin, F]``, kept OIHW here), so
    checkpoints interchange with the ``"conv"`` stem.  The 4×4×4Cin
    kernel is derived from it on every call."""

    def __init__(self, in_features: int, features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 7, 7))
        lecun_normal_(self.weight, generator)

    def forward(self, x):
        b, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(
                f"space_to_depth stem needs even spatial dims, got "
                f"{(h, w)}; use stem='conv' for odd input sizes")
        f = self.weight.shape[0]
        # y[p, q, (a, b, ch)] = x[2p + a, 2q + b, ch], built on the NHWC view
        y = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        # one leading zero row and column make the 7x7 kernel's index
        # 2(p - i) + a + 3 the 8x8 one's 2P + a (P = p - i + 2 in [0, 4))
        k8 = F.pad(self.weight.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))
        kp = k8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5) \
            .reshape(4, 4, 4 * c, f)
        return F.conv2d(F.pad(y.permute(0, 3, 1, 2), (2, 1, 2, 1)),
                        kp.permute(3, 2, 0, 1))


class BatchNormReLU(nn.Module):
    """flax's ``BatchNormReLU``: BatchNorm then ReLU with the
    normalize+activate pass fused into K6.  The batch mean and the fast
    variance ``E[x²] − E[x]²`` (clamped at 0) are float32 torch ops under
    autograd, so gradients reach x through the statistics as in flax; the
    running averages blend at ``momentum`` (0.9) under ``no_grad``.  Parameters
    and statistics are BatchNorm's (``weight``/``bias`` → flax
    ``scale``/``bias``, ``running_mean``/``running_var`` → ``mean``/
    ``var``)."""

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, features: int, *, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        """``x``: NCHW over NHWC memory; the same out."""
        with autocast_off(x):
            x = x.to(self.dtype)
            if self.training:
                xf = x.float()
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3))
                                      - mean * mean, 0.0)
                _blend(self, mean, var)
            else:
                mean, var = self.running_mean, self.running_var
            scale = self.weight.float() * torch.rsqrt(var + self.epsilon)
            bias = self.bias.float() - mean * scale
            return scale_bias_relu(x.permute(0, 2, 3, 1), scale, bias) \
                .permute(0, 3, 1, 2)


def _blend(module: nn.Module, mean: torch.Tensor, var: torch.Tensor) -> None:
    """``ra = m·ra + (1 − m)·batch`` for both running statistics, in
    place, outside autograd."""
    m = module.momentum
    with torch.no_grad():
        module.running_mean.copy_(m * module.running_mean + (1 - m) * mean)
        module.running_var.copy_(m * module.running_var + (1 - m) * var)


class PallasConvBN3x3(nn.Module):
    """flax's ``PallasConvBN3x3``: a stride-1 3×3 conv + BatchNorm + ReLU.
    Train mode runs :func:`conv3x3_bn_relu_train` (K9 forward, the full
    BatchNorm backward with K10 for dx) and blends the batch statistics
    into the running ones; eval mode runs :func:`conv3x3_bn_relu` (K8)
    with the folded affine.  ``weight`` is the conv kernel, OIHW here
    (flax's ``kernel`` is HWIO); ``scale`` / ``bias`` and the running
    ``mean`` / ``var`` keep flax's names."""

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, in_features: int, features: int, *,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        lecun_normal_(self.weight, generator)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        """``x``: NCHW over NHWC memory; the same out."""
        with autocast_off(x):
            x = x.to(self.dtype).permute(0, 2, 3, 1)
            k = self.weight.to(self.dtype).permute(2, 3, 1, 0)  # HWIO
            if self.training:
                out, mean, var = conv3x3_bn_relu_train(
                    x, k, self.scale.float(), self.bias.float(),
                    self.epsilon)
                _blend(self, mean, var)
            else:
                scale = self.scale * torch.rsqrt(self.running_var
                                                 + self.epsilon)
                bias = self.bias - self.running_mean * scale
                out = conv3x3_bn_relu(x, k, scale, bias)
            return out.permute(0, 3, 1, 2)


def _norm_relu(norm: nn.Module, y):
    """A BatchNorm and the ReLU after it: one module under norm_act
    (:class:`BatchNormReLU`), else the pair."""
    return norm(y) if isinstance(norm, BatchNormReLU) else F.relu(norm(y))


class Variants(NamedTuple):
    """The reference's kernel options as the blocks see them."""

    norm_act: bool = False       # norm_act="pallas"
    residual_join: bool = False  # residual_join="pallas"
    conv_bn: bool = False        # conv_bn="pallas"
    dtype: torch.dtype = torch.bfloat16


class _Names:
    """flax's automatic names: one counter per module class, in the order
    the modules are made."""

    def __init__(self):
        self.counts: Dict[str, int] = {}

    def __call__(self, cls: str) -> str:
        k = self.counts.get(cls, 0)
        self.counts[cls] = k + 1
        return f"{cls}_{k}"


class _Block(nn.Module):
    """What both blocks share: their modules registered under flax's
    names, the norm+ReLU pairs and the residual join."""

    def __init__(self, variants: Variants, generator):
        super().__init__()
        self._variants = variants
        # used while the block is built, then dropped (_built)
        self._names = _Names()
        self._generator = generator

    def _built(self) -> None:
        del self._names, self._generator

    def _add(self, cls: str, module: nn.Module) -> str:
        name = self._names(cls)
        self.add_module(name, module)
        return name

    def _conv(self, *args, **kwargs) -> str:
        return self._add("Conv", Conv(*args, generator=self._generator,
                                      **kwargs))

    def _norm_relu(self, features: int) -> str:
        """A BatchNorm that a ReLU follows: fused under norm_act."""
        if self._variants.norm_act:
            return self._add("BatchNormReLU", BatchNormReLU(
                features, dtype=self._variants.dtype))
        return self._add("BatchNorm", BatchNorm(features))

    def _fused(self, in_features: int, features: int) -> str:
        return self._add("PallasConvBN3x3", PallasConvBN3x3(
            in_features, features, dtype=self._variants.dtype,
            generator=self._generator))

    def _apply_norm_relu(self, name: str, y):
        return _norm_relu(getattr(self, name), y)

    def _join(self, residual, y):
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        if self._variants.residual_join:
            with autocast_off(y):
                y = y.to(residual.dtype)
                return residual_relu(residual.permute(0, 2, 3, 1),
                                     y.permute(0, 2, 3, 1)) \
                    .permute(0, 3, 1, 2)
        return F.relu(residual + y)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int, *,
                 variants: Variants = Variants(),
                 generator: Optional[torch.Generator] = None):
        super().__init__(variants, generator)
        out = filters * self.expansion
        self.conv_a = self._conv(in_features, filters, 1)
        self.norm_a = self._norm_relu(filters)
        self.fused = None
        if variants.conv_bn and strides == 1:
            self.fused = self._fused(filters, filters)
        else:
            self.conv_b = self._conv(filters, filters, 3, strides)
            self.norm_b = self._norm_relu(filters)
        self.conv_c = self._conv(filters, out, 1)
        self.norm_c = self._add("BatchNorm", BatchNorm(out, zero_scale=True))
        self.conv_proj = self.norm_proj = None
        if in_features != out or strides != 1:
            self.conv_proj = Conv(in_features, out, 1, strides,
                                  generator=generator)
            self.norm_proj = BatchNorm(out)
        self._built()

    def forward(self, x):
        y = self._apply_norm_relu(self.norm_a, getattr(self, self.conv_a)(x))
        if self.fused is not None:
            y = getattr(self, self.fused)(y)
        else:
            y = self._apply_norm_relu(self.norm_b,
                                      getattr(self, self.conv_b)(y))
        y = getattr(self, self.norm_c)(getattr(self, self.conv_c)(y))
        return self._join(x, y)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int, *,
                 variants: Variants = Variants(),
                 generator: Optional[torch.Generator] = None):
        super().__init__(variants, generator)
        self.fused = None
        if variants.conv_bn and strides == 1:
            # only the first 3x3 is fused: the second one's BatchNorm has
            # no ReLU before the join
            self.fused = self._fused(in_features, filters)
        else:
            self.conv_a = self._conv(in_features, filters, 3, strides)
            self.norm_a = self._norm_relu(filters)
        self.conv_b = self._conv(filters, filters, 3)
        self.norm_b = self._add("BatchNorm", BatchNorm(filters,
                                                       zero_scale=True))
        self.conv_proj = self.norm_proj = None
        if in_features != filters or strides != 1:
            self.conv_proj = Conv(in_features, filters, 1, strides,
                                  generator=generator)
            self.norm_proj = BatchNorm(filters)
        self._built()

    def forward(self, x):
        if self.fused is not None:
            y = getattr(self, self.fused)(x)
        else:
            y = self._apply_norm_relu(self.norm_a,
                                      getattr(self, self.conv_a)(x))
        y = getattr(self, self.norm_b)(getattr(self, self.conv_b)(y))
        return self._join(x, y)


def _option(option: str, value: str, valid: Sequence[str]) -> bool:
    """Whether ``value`` selects the option's second (kernel) choice."""
    if value not in valid:
        raise ValueError(f"unknown {option} {value!r} (want one of {valid})")
    return value == valid[1]


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, stem: str = "conv",
                 residual_join: str = "xla", conv_bn: str = "xla",
                 norm_act: str = "xla", in_features: int = 3, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        space_to_depth = _option("stem", stem, ("conv", "space_to_depth"))
        variants = Variants(
            norm_act=_option("norm_act", norm_act, ("xla", "pallas")),
            residual_join=_option("residual_join", residual_join,
                                  ("xla", "pallas")),
            conv_bn=_option("conv_bn", conv_bn, ("xla", "pallas")),
            dtype=dtype)
        self.dtype = dtype
        if space_to_depth:
            self.conv_init = SpaceToDepthConvInit(in_features, num_filters,
                                                  generator=generator)
        else:
            self.conv_init = Conv(in_features, num_filters, 7, 2,
                                  padding=((3, 3), (3, 3)),
                                  generator=generator)
        self.bn_init = BatchNormReLU(num_filters, dtype=dtype) \
            if variants.norm_act else BatchNorm(num_filters)
        width = num_filters
        k = 0
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = 2 if i > 0 and j == 0 else 1
                block = block_cls(width, num_filters * 2 ** i, strides,
                                  variants=variants, generator=generator)
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
            x = self.conv_init(x)
            x = _norm_relu(self.bn_init, x)
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
