"""Flash attention: the port of ``horovod_tpu/ops/flash_attention.py``.

Three kernels carry it, written by hand for Hopper in
``csrc/flash_attention.cu`` and launched through ``kernels.py``:

* K2, the blockwise online-softmax forward (the reference's
  ``_fwd_kernel``), returning ``(o, m, l)``;
* K3, dq (``_bwd_dq_kernel``);
* K4, dk and dv (``_bwd_dkv_kernel``).

Each launch runs on the mainloop that ``kernels.flash_plan`` names: TMA
+ ``wgmma`` for K2 and K4 on bf16 operands of head dim 64 that TMA can
address (GPT-2's path), ``mma.sync`` for other bf16 operands and for K3,
scalar float32 kernels for float32.

Beside each is its plain PyTorch version (:func:`plain_mha_fwd`,
:func:`plain_mha_bwd_dq`, :func:`plain_mha_bwd_dkv`), which follows the
Pallas body's arithmetic and casts: the finite ``NEG_INF`` mask applied
before the max and again to ``p``; in the forward, the online softmax
over kv tiles (``kv_tile`` keys, :data:`KV_TILE` by default; the card's
checks pass the plan's tile) with ``p`` cast to v's dtype against the
running max before ``p·v``, so a bf16 ``p`` is rounded where the kernel
rounds it; ``ds = p·(dp − delta)·scale``
cast to k's (q's) dtype before its product; float32 sums.  CPU tensors
take the plain version; any other tensor goes to the kernel, which
raises on what it does not take.  Nothing falls back.
:func:`plain_flash_attention` is :func:`flash_attention` through the
plain versions on any device: the oracle that holds the kernels to
account through a whole model on the card.

Public functions keep the reference's layouts and signatures:
:func:`flash_attention` and :func:`softmax_attention` take ``[b, s, h,
d]``; :func:`mha_partial`, :func:`mha_bwd_dq` and :func:`mha_bwd_dkv`
(the ring-attention building blocks) take ``[b, h, s, d]`` and global
offsets.  The reference's ``block_q`` / ``block_k`` / ``interpret``
arguments are TPU tiling and have no counterpart: the kernels' tiles are
their plan's, and they mask any ragged tail themselves.  Offsets are host
integers here.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from .. import kernels

# Finite stand-in for -inf: exp(NEG_INF - NEG_INF) = 1 for a fully masked
# row, then zeroed by the second mask select, so no NaN appears.
NEG_INF = -1e30

#: keys per kv tile of the plain forward's online softmax by default: the
#: mma.sync and float32 kernels' tile (the TMA + wgmma K2 takes 128,
#: ``kernels.flash_plan``)
KV_TILE = 64


# ---------------------------------------------------------------------------
# plain versions of K2-K4, on [b, h, s, d]
# ---------------------------------------------------------------------------
def _causal_mask(sq: int, sk: int, q_offset: int, kv_offset: int,
                 device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = kv_offset + torch.arange(sk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _scores(q, k, *, causal, scale, q_offset, kv_offset):
    """``s = (q·kᵀ in float32) · scale`` masked to NEG_INF, and the mask
    (None when nothing is masked)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if not causal:
        return s, None
    mask = _causal_mask(q.shape[2], k.shape[2], q_offset, kv_offset,
                        q.device)
    return torch.where(mask, s, NEG_INF), mask


def _probs(s, mask, row_max):
    p = torch.exp(s - row_max)
    return p if mask is None else torch.where(mask, p, 0.0)


def plain_mha_fwd(q, k, v, *, causal: bool, scale: float, q_offset: int = 0,
                  kv_offset: int = 0, normalize: bool = True,
                  kv_tile: int = KV_TILE
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's plain version: ``(o, m, l)``; o in q's dtype (normalized) or
    float32, m and l float32 ``[b, h, sq, 1]``.  The online softmax runs
    over kv tiles of ``kv_tile`` keys as the Pallas body's grid does:
    ``m`` is the running max, and each tile's ``p`` is rounded to v's
    dtype against it before ``p·v``."""
    b, h, sq, _ = q.shape
    m = torch.full((b, h, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, v.shape[-1]), device=q.device)
    for k0 in range(0, k.shape[2], kv_tile):
        kb, vb = k[:, :, k0:k0 + kv_tile], v[:, :, k0:k0 + kv_tile]
        s, mask = _scores(q, kb, causal=causal, scale=scale,
                          q_offset=q_offset, kv_offset=kv_offset + k0)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = _probs(s, mask, m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    if normalize:
        return (acc / l.clamp_min(1e-30)).to(q.dtype), m, l
    return acc, m, l


def _grad_terms(q, k, v, do, lse, delta, *, causal, scale, q_offset,
                kv_offset):
    s, mask = _scores(q, k, causal=causal, scale=scale, q_offset=q_offset,
                      kv_offset=kv_offset)
    p = _probs(s, mask, lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta) * scale


def plain_mha_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                     q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """K3's plain version: dq in float32."""
    _, ds = _grad_terms(q, k, v, do, lse, delta, causal=causal, scale=scale,
                        q_offset=q_offset, kv_offset=kv_offset)
    return torch.matmul(ds.to(k.dtype).float(), k.float())


def plain_mha_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                      scale: float, q_offset: int = 0, kv_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: ``(dk, dv)`` in float32."""
    p, ds = _grad_terms(q, k, v, do, lse, delta, causal=causal,
                        scale=scale, q_offset=q_offset, kv_offset=kv_offset)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk, dv


# ---------------------------------------------------------------------------
# dispatch: the plain version for CPU tensors, the kernel for any other
# ---------------------------------------------------------------------------
def _mha_fwd(q, k, v, **kw):
    if q.device.type == "cpu":
        return plain_mha_fwd(q, k, v, **kw)
    return kernels.launch_flash_fwd(q, k, v, **kw)


def _mha_bwd_dq(q, k, v, do, lse, delta, **kw):
    if q.device.type == "cpu":
        return plain_mha_bwd_dq(q, k, v, do, lse, delta, **kw)
    return kernels.launch_flash_bwd_dq(q, k, v, do, lse, delta, **kw)


def _mha_bwd_dkv(q, k, v, do, lse, delta, **kw):
    if q.device.type == "cpu":
        return plain_mha_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return kernels.launch_flash_bwd_dkv(q, k, v, do, lse, delta, **kw)


# ---------------------------------------------------------------------------
# ring building blocks ([b, h, s, d], global offsets)
# ---------------------------------------------------------------------------
def mha_partial(q, k, v, q_offset, kv_offset, *, causal: bool,
                scale: float):
    """Unnormalized streaming triple ``(o[f32], m, l)`` for one q-shard ×
    kv-shard pair; m and l come back ``[b, h, sq, 1]``."""
    return _mha_fwd(q, k, v, causal=causal, scale=scale,
                    q_offset=int(q_offset), kv_offset=int(kv_offset),
                    normalize=False)


def mha_bwd_dq(q, k, v, do, lse, delta, q_offset, kv_offset, *,
               causal: bool, scale: float):
    """dq (float32) contribution of one kv shard; lse and delta are
    ``[b, h, sq, 1]``."""
    return _mha_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale,
                       q_offset=int(q_offset), kv_offset=int(kv_offset))


def mha_bwd_dkv(q, k, v, do, lse, delta, q_offset, kv_offset, *,
                causal: bool, scale: float):
    """``(dk, dv)`` (float32) contributions of one q shard to one kv
    shard."""
    return _mha_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale,
                        q_offset=int(q_offset), kv_offset=int(kv_offset))


# ---------------------------------------------------------------------------
# local flash attention, differentiable
# ---------------------------------------------------------------------------
#: K2, K3, K4 (each the kernel on a card tensor, its plain version on a
#: CPU tensor), and their plain versions on any device
_KERNELS = (_mha_fwd, _mha_bwd_dq, _mha_bwd_dkv)
_PLAIN = (plain_mha_fwd, plain_mha_bwd_dq, plain_mha_bwd_dkv)


class _FlashAttention(torch.autograd.Function):
    """K2 forward; K3 then K4 backward (the reference's custom VJP), or
    the three plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_offset, impl):
        kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                  kv_offset=kv_offset)
        o, m, l = impl[0](q, k, v, normalize=True, **kw)
        lse = m + torch.log(l.clamp_min(1e-30))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.impl = kw, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1, keepdim=True).contiguous()
        dq = ctx.impl[1](q, k, v, do, lse, delta, **ctx.kw)
        dk, dv = ctx.impl[2](q, k, v, do, lse, delta, **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def _flash(q, k, v, causal, scale, q_offset, kv_offset, impl):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), bool(causal), float(scale),
                              int(q_offset), int(kv_offset), impl)
    return o.transpose(1, 2).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_offset: int = 0):
    """Flash attention over local shards, differentiable end to end.

    ``q``, ``k``, ``v``: ``[batch, seq, heads, head_dim]``.  ``causal``
    masks in global positions (``q_offset + i >= kv_offset + j``);
    ``scale`` defaults to ``1/sqrt(head_dim)``.  Returns the attention
    output, same shape and dtype as ``q``."""
    return _flash(q, k, v, causal, scale, q_offset, kv_offset, _KERNELS)


def plain_flash_attention(q, k, v, *, causal: bool = False,
                          scale: Optional[float] = None, q_offset: int = 0,
                          kv_offset: int = 0, kv_tile: int = KV_TILE):
    """:func:`flash_attention` through the plain versions of K2-K4 on any
    device, the forward's online softmax over ``kv_tile`` keys a tile: the
    kernels' oracle, never called on the training path."""
    impl = (functools.partial(plain_mha_fwd, kv_tile=kv_tile), *_PLAIN[1:])
    return _flash(q, k, v, causal, scale, q_offset, kv_offset, impl)


def softmax_attention(q, k, v, *, causal: bool = False,
                      scale: Optional[float] = None):
    """Plain (materialized) softmax attention in ``[b, s, h, d]`` layout:
    the reference's ``--attn xla`` path and the flash kernels' oracle.
    Memory is O(s²)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    sl = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        sl = sl.masked_fill(~(pos[:, None] >= pos[None, :]), -math.inf)
    p = torch.softmax(sl, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
