"""Pre-LN Transformer encoder: the port of ``horovod_tpu/models/bert.py``.

Computes what the flax modules compute, cast for cast: parameters in
float32, every Dense / DenseGeneral / Embed in the compute ``dtype``
(bf16 by default), LayerNorm statistics in float32 with its output in
``dtype``, so the residual stream is in ``dtype`` too.  The casts are
explicit: autocast would keep the residual stream and the LayerNorm
outputs in float32.  The MLP's GELU is flax's default, the tanh
approximation.

Submodules carry flax's names (``Embed_0``, ``EncoderLayer_3``,
``SelfAttention_0/query``, ``LayerNorm_1``...), so ``convert.py`` maps
parameters by name.  ``attention_fn(q, k, v, mask) -> out`` on ``[b, s,
h, d]`` replaces the materialized attention, as in the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, DenseGeneral, Embed, LayerNorm


class SelfAttention(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, *,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.dtype = dtype
        self.attention_fn = attention_fn
        heads = (num_heads, self.head_dim)
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral(
                (hidden_dim,), heads, dtype=dtype, generator=generator))
        self.out = DenseGeneral(heads, (hidden_dim,), dtype=dtype,
                                generator=generator)

    def forward(self, x, mask=None):
        q, k, v = self.query(x), self.key(x), self.value(x)
        if self.attention_fn is not None:
            out = self.attention_fn(q, k, v, mask)
        else:
            scale = 1.0 / math.sqrt(self.head_dim)
            logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
            if mask is not None:
                # float32 like the reference's where() against a float32
                # fill: in bf16 the fill would round to -inf
                logits = torch.where(mask, logits.float(),
                                     torch.finfo(torch.float32).min)
            probs = torch.softmax(logits.float(), dim=-1).to(self.dtype)
            out = torch.einsum("...hqk,...khd->...qhd", probs, v)
        return self.out(out)


class EncoderLayer(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int, *,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype=dtype)
        self.SelfAttention_0 = SelfAttention(
            hidden_dim, num_heads, dtype=dtype, attention_fn=attention_fn,
            generator=generator)
        self.LayerNorm_1 = LayerNorm(hidden_dim, dtype=dtype)
        self.Dense_0 = Dense(hidden_dim, mlp_dim, dtype=dtype,
                             generator=generator)
        self.Dense_1 = Dense(mlp_dim, hidden_dim, dtype=dtype,
                             generator=generator)

    def forward(self, x, mask=None):
        x = x + self.SelfAttention_0(self.LayerNorm_0(x), mask)
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class BertEncoder(nn.Module):
    """Pre-LN BERT-style encoder over token ids -> float32 features."""

    def __init__(self, vocab_size: int = 30522, hidden_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512, *,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.Embed_0 = Embed(vocab_size, hidden_dim, dtype=dtype,
                             generator=generator)
        self.Embed_1 = Embed(max_len, hidden_dim, dtype=dtype,
                             generator=generator)
        for i in range(num_layers):
            self.add_module(f"EncoderLayer_{i}", EncoderLayer(
                hidden_dim, num_heads, mlp_dim, dtype=dtype,
                attention_fn=attention_fn, generator=generator))
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype=dtype)

    def forward(self, ids, mask=None):
        pos = torch.arange(ids.shape[-1], device=ids.device)[None, :]
        x = self.Embed_0(ids) + self.Embed_1(pos)
        for i in range(self.num_layers):
            x = getattr(self, f"EncoderLayer_{i}")(x, mask)
        return self.LayerNorm_0(x).float()


def bert_base(**kw) -> BertEncoder:
    return BertEncoder(**kw)


def bert_tiny(**kw) -> BertEncoder:
    """4-layer / 128-dim variant for tests and CPU dry-runs."""
    for k, v in (("vocab_size", 1024), ("hidden_dim", 128),
                 ("num_layers", 4), ("num_heads", 4), ("mlp_dim", 256),
                 ("max_len", 512)):
        kw.setdefault(k, v)
    return BertEncoder(**kw)
