"""Small MLP and convnet for the cheap parity tests and the serving
fixtures: the port of ``horovod_tpu/models/mlp.py`` ``MLP`` and
``ConvNet``.  flax infers the input width at init; a torch module is told
it (``in_features``, ``image_size``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, Dense


class MLP(nn.Module):
    def __init__(self, in_features: int,
                 features: Sequence[int] = (128, 64, 10),
                 dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.num_layers = len(features)
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}",
                            Dense(in_features, f, generator=generator))
            in_features = f

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            for i in range(self.num_layers):
                x = getattr(self, f"Dense_{i}")(x)
                if i < self.num_layers - 1:
                    x = F.relu(x)
        return x


class ConvNet(nn.Module):
    """The reference's ``ConvNet`` (the examples/tensorflow2_mnist.py
    shape): two 3×3 SAME convs with bias (32 then 64 features), each
    followed by ReLU and a 2×2 stride-2 max pool, then Dense 128, ReLU,
    Dense ``num_classes``.  The input is NHWC like the reference's
    (``[b, h, w]`` gets a channel axis) and is flattened in NHWC order
    before ``Dense_0``, so the flax kernels convert by ``convert.py``'s
    Conv / Dense rules.  flax infers ``Dense_0``'s width at init; a torch
    module is told the image size (``image_size``)."""

    def __init__(self, image_size: int = 28, in_features: int = 1,
                 num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(in_features, 32, 3, use_bias=True,
                           generator=generator)
        self.Conv_1 = Conv(32, 64, 3, use_bias=True, generator=generator)
        side = image_size // 2 // 2
        self.Dense_0 = Dense(side * side * 64, 128, generator=generator)
        self.Dense_1 = Dense(128, num_classes, generator=generator)

    def forward(self, x):
        if x.ndim == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
            x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = F.relu(self.Dense_0(x))
            return self.Dense_1(x)
