"""Small MLP for the cheap parity tests: the port of
``horovod_tpu/models/mlp.py`` ``MLP``.  flax infers the input width at
init; a torch module is told it (``in_features``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense


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
