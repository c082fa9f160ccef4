"""Vision Transformer: the port of ``horovod_tpu/models/vit.py``.

The patches are one strided conv (``patch_embed``, flax ``"SAME"``, which
pads nothing when the image size divides by the patch, as the reference
requires), flattened in (h, w) row order into tokens; a learnable class
token ``cls`` (zeros) goes first, then ``pos_embed`` (normal, stddev
0.02) is added.  Both are bare parameters of the ViT module, under their
flax names.  Then the port's pre-LN ``EncoderLayer``s (``models/bert.py``:
LayerNorm at epsilon 1e-6, tanh GELU), a final ``LayerNorm_0``, and the
``head`` Dense computed in float32 on the class token.

Precision as in ``bert.py``: float32 parameters, every Dense and the
patch conv in ``dtype`` (bf16 by default), explicit casts.
``attention_fn(q, k, v, mask)`` replaces the materialized attention, as
in the reference, whose default is the materialized one.  ``image_size``
sizes ``pos_embed`` (flax infers it at ``init``).  ``train`` is the
reference's interface and changes nothing: there is no BatchNorm and no
dropout.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .bert import EncoderLayer
from .layers import Conv, Dense, LayerNorm


class ViT(nn.Module):
    """ViT over NHWC images -> float32 logits ``[b, num_classes]``."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 hidden_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
                 in_features: int = 3,
                 attention_fn: Optional[Callable] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image {image_size}x{image_size} not "
                             f"divisible by patch {patch_size}")
        self.dtype = dtype
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.patch_embed = Conv(in_features, hidden_dim, patch_size,
                                patch_size, use_bias=True,
                                generator=generator)
        tokens = (image_size // patch_size) ** 2 + 1
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, hidden_dim))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for i in range(num_layers):
            self.add_module(f"EncoderLayer_{i}", EncoderLayer(
                hidden_dim, num_heads, mlp_dim, dtype=dtype,
                attention_fn=attention_fn, generator=generator))
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype=dtype)
        self.head = Dense(hidden_dim, num_classes, dtype=torch.float32,
                          generator=generator)

    def forward(self, x):
        """``x``: ``[batch, height, width, channels]``."""
        b = x.shape[0]
        w = self.patch_embed.weight.to(self.dtype)
        bias = self.patch_embed.bias.to(self.dtype)
        x = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), w, bias,
                     self.patch_embed.stride)
        x = x.flatten(2).transpose(1, 2)  # [b, (h, w) patches, d]
        cls = self.cls.to(self.dtype).expand(b, 1, self.hidden_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"EncoderLayer_{i}")(x)
        x = self.LayerNorm_0(x)
        return self.head(x[:, 0])


# standard variants (Dosovitskiy et al. table 1 shapes)
ViT_S16 = partial(ViT, patch_size=16, hidden_dim=384, num_layers=12,
                  num_heads=6, mlp_dim=1536)
ViT_B16 = partial(ViT, patch_size=16, hidden_dim=768, num_layers=12,
                  num_heads=12, mlp_dim=3072)
ViT_L16 = partial(ViT, patch_size=16, hidden_dim=1024, num_layers=24,
                  num_heads=16, mlp_dim=4096)
