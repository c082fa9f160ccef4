"""Decoder-only Transformer LM: the port of ``horovod_tpu/models/gpt.py``.

Pre-LN encoder layers (``bert.py``) under a causal attention core that
defaults to the flash kernels K2-K4 (``ops/flash_attention.py``), token
and position embeddings ``wte`` / ``wpe``, a final ``LayerNorm_0`` and a
weight-tied head: ``wte.attend`` in the compute dtype (bf16 by default),
cast to float32 logits.  Parameters are float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.flash_attention import flash_attention
from .bert import EncoderLayer
from .layers import Embed, LayerNorm


def causal_flash_attention_fn(q, k, v, mask):
    """The default causal core: K2-K4 on the card, their plain versions on
    CPU tensors."""
    del mask
    return flash_attention(q, k, v, causal=True)


class GPT(nn.Module):
    """Decoder-only LM over token ids -> float32 logits ``[b, s, vocab]``.

    ``attention_fn(q, k, v, mask)`` must apply causal masking itself, as
    the default does."""

    def __init__(self, vocab_size: int = 50257, hidden_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 1024, *,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_len = max_len
        attn = attention_fn or causal_flash_attention_fn
        self.wte = Embed(vocab_size, hidden_dim, dtype=dtype,
                         generator=generator)
        self.wpe = Embed(max_len, hidden_dim, dtype=dtype,
                         generator=generator)
        for i in range(num_layers):
            self.add_module(f"EncoderLayer_{i}", EncoderLayer(
                hidden_dim, num_heads, mlp_dim, dtype=dtype,
                attention_fn=attn, generator=generator))
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype=dtype)

    def forward(self, ids, seq_offset: int = 0):
        pos = seq_offset + torch.arange(ids.shape[-1], device=ids.device)
        x = self.wte(ids) + self.wpe(pos[None, :])
        for i in range(self.num_layers):
            x = getattr(self, f"EncoderLayer_{i}")(x)
        x = self.LayerNorm_0(x)
        # weight-tied head: x · wteᵀ, float32 logits for the softmax
        return self.wte.attend(x.float()).float()


def gpt2_small(**kw) -> GPT:
    return GPT(**kw)


def gpt_tiny(**kw) -> GPT:
    """4-layer / 128-dim variant for tests and CPU dry-runs."""
    for k, v in (("vocab_size", 1024), ("hidden_dim", 128),
                 ("num_layers", 4), ("num_heads", 4), ("mlp_dim", 256),
                 ("max_len", 512)):
        kw.setdefault(k, v)
    return GPT(**kw)


def next_token_loss(logits, ids):
    """Shifted cross-entropy: predict ``ids[t+1]`` from position ``t``."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(logp, -1, ids[:, 1:, None].long())
    return -ll.mean()
