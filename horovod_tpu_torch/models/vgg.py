"""VGG family: the port of ``horovod_tpu/models/vgg.py``.

VGG-16 is in the reference's published scaling table; its 138,357,544
parameters (at 224×224, 1000 classes) are the largest gradient payload
of the registry.  Same layers, names and initialization as the flax
model: 3×3 convs padded 1 with a bias (``Conv_0`` ...), each followed by
an optional BatchNorm (``BatchNorm_k``, momentum 0.9, epsilon 1e-5) and a
ReLU, 2×2 stride-2 max pools, then the classifier 4096-4096-classes
(``Dense_0``-``Dense_2``) with an optional dropout, and float32 logits.

Layout and precision as in ``resnet.py``: NHWC input viewed as NCHW over
channels-last memory, float32 parameters, ``dtype`` (bf16 by default)
under ``torch.autocast``.  The reference flattens its NHWC activations,
so the first Dense's rows are in (h, w, c) order; the forward flattens
the channels-last view the same way, and the converter keeps the one
Dense rule.  ``image_size`` sizes that first Dense (flax infers it at
``init``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense

# channels per conv, "M" = 2x2 maxpool (the classic configurations)
_CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    def __init__(self, cfg: Sequence, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 batch_norm: bool = False, dropout: float = 0.0,
                 image_size: int = 224, in_features: int = 3, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = tuple(cfg)
        self.dtype = dtype
        self.dropout = dropout
        width, size, k = in_features, image_size, 0
        for item in self.cfg:
            if item == "M":
                size //= 2
                continue
            self.add_module(f"Conv_{k}", Conv(
                width, item, 3, padding=((1, 1), (1, 1)), use_bias=True,
                generator=generator))
            if batch_norm:
                self.add_module(f"BatchNorm_{k}", BatchNorm(item))
            width, k = item, k + 1
        if size < 1:
            raise ValueError(f"image size {image_size} is too small for "
                             f"{self.cfg.count('M')} 2x2 max pools")
        self.batch_norm = batch_norm
        self.Dense_0 = Dense(width * size * size, 4096, generator=generator)
        self.Dense_1 = Dense(4096, 4096, generator=generator)
        self.Dense_2 = Dense(4096, num_classes, generator=generator)

    def forward(self, x):
        """``x``: ``[batch, height, width, channels]``; returns float32
        logits ``[batch, num_classes]``."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            k = 0
            for item in self.cfg:
                if item == "M":
                    x = F.max_pool2d(x, 2, 2)
                    continue
                x = getattr(self, f"Conv_{k}")(x)
                if self.batch_norm:
                    x = getattr(self, f"BatchNorm_{k}")(x)
                x = F.relu(x)
                k += 1
            # flatten in the reference's NHWC order: (h, w, c)
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            for dense in (self.Dense_0, self.Dense_1):
                x = F.relu(dense(x))
                if self.dropout:
                    x = F.dropout(x, self.dropout, self.training)
            x = self.Dense_2(x)
        return x.float()


VGG11 = partial(VGG, cfg=_CFGS[11])
VGG16 = partial(VGG, cfg=_CFGS[16])
VGG19 = partial(VGG, cfg=_CFGS[19])
