"""Sequence parallelism, ring attention and Ulysses: the port of
``horovod_tpu/parallel/ring_attention.py``.

* :func:`ring_attention` — attention over a sequence sharded across the
  ranks of an axis, the K/V shards rotating one rank on per hop (one
  ``batch_isend_irecv`` a hop: send to ``my + 1``, receive from ``my -
  1``) and the partials merged by the online softmax; causal masking in
  global positions.  ``impl="xla"`` is the reference's lax form in torch
  ops, differentiable through the rotation's inverse; ``impl="flash"``
  (the reference's ``pallas``) runs the flash kernels per hop: K2
  unnormalized (``mha_partial``), then K3 and K4 in the backward, where
  the dk/dv accumulators travel with their kv shards so that after ``n``
  hops each rank holds its own shard's gradient.
* :func:`ulysses_attention` — one all-to-all from sequence-sharded to
  head-sharded, full attention on this rank's heads, one back.

``axis`` picks the sequence axis (``parallel/mesh.py``): the world by
default, ``"sp"`` of a ``(dp, sp)`` mesh in use to compose with data
parallelism, or a process group.

The flash ring's hop arithmetic is in functions of its own
(:func:`ring_carry`, :func:`ring_fwd_hop`, :func:`ring_finish`,
:func:`ring_bwd_hop`), which the distributed ring calls between
rotations; ``chip_smoke.py`` drives the same functions for several
virtual ranks in lockstep on one card.  A hop's offsets are host ints
(see :class:`_RingFlash`), so no hop reads a device scalar and a ring
step stays capturable in a CUDA graph.

Not ported: the reference's remarks on its schedule checker
(``hvd_verify``) and the replication checker: there is no SPMD program
here to check; each rank runs every rotation, forward and backward.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops import flash_attention as fa
from .mesh import Axis, all_to_all, axis_group, ppermute, rotate

# ---------------------------------------------------------------------------
# the xla form: the reference's lax ops in torch
# ---------------------------------------------------------------------------
def _block_attn(q, k, v, *, scale, mask=None):
    """One q-block × kv-block partial attention: the streaming triple
    (unnormalized out, row max, row sumexp) in float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask, s, -math.inf)
    m = s.amax(-1)                                # [b, h, q]
    # guard fully masked rows (all -inf)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(-1)                                 # [b, h, q]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return o, m_safe, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two streaming-softmax partials (the flash combine)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    # broadcast [b, h, q] to [b, q, h, 1]
    o = o1 * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return o, m, l


def _ring_xla(q, k, v, *, causal, scale, group):
    n, my = dist.get_world_size(group), dist.get_rank(group)
    b, seq, h, d = q.shape

    def causal_mask(owner):
        if not causal:
            return None
        q_pos = my * seq + torch.arange(seq, device=q.device)
        k_pos = owner * seq + torch.arange(seq, device=q.device)
        return (q_pos[:, None] >= k_pos[None, :])[None, None]

    o = torch.zeros((b, seq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, seq), -math.inf, device=q.device)
    l = torch.zeros((b, h, seq), device=q.device)
    kc, vc = k, v
    for hop in range(n):
        owner = (my - hop) % n
        o, m, l = _merge(o, m, l, *_block_attn(q, kc, vc, scale=scale,
                                               mask=causal_mask(owner)))
        if hop < n - 1:   # the reference's last rotation is never read
            kc, vc = ppermute((kc, vc), group)
    denom = l.transpose(1, 2)[..., None]
    return (o / denom.clamp_min(1e-30)).to(q.dtype)


# ---------------------------------------------------------------------------
# the flash form: K2 unnormalized per hop, K3 and K4 in the backward
# ---------------------------------------------------------------------------
class HopOps(NamedTuple):
    """The three calls of a hop, with the signatures of the reference's
    ``mha_partial``, ``mha_bwd_dq`` and ``mha_bwd_dkv``."""

    partial: Callable
    bwd_dq: Callable
    bwd_dkv: Callable


#: K2 unnormalized, K3, K4: the kernels on a card tensor, their plain
#: versions on a CPU tensor
HOP_KERNELS = HopOps(fa.mha_partial, fa.mha_bwd_dq, fa.mha_bwd_dkv)


def plain_hop_ops(kv_tile: int = fa.KV_TILE) -> HopOps:
    """The plain versions of K2-K4 on any device, the forward's online
    softmax over ``kv_tile`` keys a tile: the kernels' oracle, never
    called on the training path."""
    def partial(q, k, v, q_offset, kv_offset, *, causal, scale):
        return fa.plain_mha_fwd(q, k, v, causal=causal, scale=scale,
                                q_offset=q_offset, kv_offset=kv_offset,
                                normalize=False, kv_tile=kv_tile)

    def bwd_dq(q, k, v, do, lse, delta, q_offset, kv_offset, *, causal,
               scale):
        return fa.plain_mha_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                   scale=scale, q_offset=q_offset,
                                   kv_offset=kv_offset)

    def bwd_dkv(q, k, v, do, lse, delta, q_offset, kv_offset, *, causal,
                scale):
        return fa.plain_mha_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                    scale=scale, q_offset=q_offset,
                                    kv_offset=kv_offset)

    return HopOps(partial, bwd_dq, bwd_dkv)


def ring_carry(q: torch.Tensor):
    """The forward's streaming triple before the first hop, for a q shard
    ``[b, h, s, d]``: o 0 in float32 laid out like q, m the finite
    ``NEG_INF`` (a wholly masked hop then gives ``exp(m - m_new)`` of 0 or
    1, never NaN), l 0, both ``[b, h, s, 1]``."""
    b, h, s, _ = q.shape
    m = torch.full((b, h, s, 1), fa.NEG_INF, device=q.device)
    return torch.zeros_like(q, dtype=torch.float32), m, torch.zeros_like(m)


def ring_fwd_hop(q, k, v, carry, q_offset: int, kv_offset: int, *,
                 causal: bool, scale: float, ops: HopOps = HOP_KERNELS):
    """One forward hop: K2 unnormalized on the resident kv shard at
    global offsets, merged into ``carry`` (o, m, l) in place in float32,
    as the reference's scan body (:211-221).  Returns ``carry``."""
    o, m, l = carry
    po, pm, pl = ops.partial(q, k, v, q_offset, kv_offset, causal=causal,
                             scale=scale)
    m_new = torch.maximum(m, pm)
    a1 = torch.exp(m - m_new)
    a2 = torch.exp(pm - m_new)
    o.mul_(a1).add_(po * a2)
    l.mul_(a1).add_(pl * a2)
    m.copy_(m_new)
    return carry


def ring_finish(carry, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The output ``o / max(l, 1e-30)`` in ``dtype`` and the global
    ``lse = m + log(max(l, 1e-30))`` over all hops, which the backward's
    hops take."""
    o, m, l = carry
    l_safe = l.clamp_min(1e-30)
    return (o / l_safe).to(dtype), m + torch.log(l_safe)


def ring_bwd_hop(q, k, v, do, lse, delta, grads, q_offset: int,
                 kv_offset: int, *, causal: bool, scale: float,
                 ops: HopOps = HOP_KERNELS):
    """One backward hop: K3's dq and K4's dk, dv contributions of the
    resident kv shard, added in place in float32 to ``grads`` (dq, dk,
    dv), dk and dv being the accumulators that travel with that shard.
    Returns ``grads``."""
    dq, dk, dv = grads
    dq.add_(ops.bwd_dq(q, k, v, do, lse, delta, q_offset, kv_offset,
                       causal=causal, scale=scale))
    dkb, dvb = ops.bwd_dkv(q, k, v, do, lse, delta, q_offset, kv_offset,
                           causal=causal, scale=scale)
    dk.add_(dkb)
    dv.add_(dvb)
    return grads


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


class _RingFlash(torch.autograd.Function):
    """The reference's ``_ring_pallas_fn`` custom VJP on ``[b, s, h, d]``
    shards; the kernels see ``[b, h, s, d]`` views of them.

    Offsets are host ints.  The reference traces ``lax.axis_index``
    because one SPMD program serves every rank; here each process is one
    rank of a group whose size is fixed, so ``my`` is a constant of its
    program and hop ``i``'s kv shard is the one owner ``(my - i) mod n``
    held: ``q_offset = my·seq`` and ``kv_offset = owner·seq`` are the
    values the reference's traced scalars take at that hop, known before
    the step runs.  The kernels take them by value, so no hop reads a
    device scalar and every hop is capturable."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, my = dist.get_world_size(group), dist.get_rank(group)
        seq = q.shape[1]
        qt = _bhsd(q)
        carry = ring_carry(qt)
        kc, vc = k, v
        for hop in range(n):
            owner = (my - hop) % n
            ring_fwd_hop(qt, _bhsd(kc), _bhsd(vc), carry, my * seq,
                         owner * seq, causal=causal, scale=scale)
            if hop < n - 1:
                kc, vc = rotate((kc, vc), group)
        out, lse = ring_finish(carry, q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return _bhsd(out)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, kw = ctx.group, dict(causal=ctx.causal, scale=ctx.scale)
        n, my = dist.get_world_size(group), dist.get_rank(group)
        seq = q.shape[1]
        qt, do = _bhsd(q), _bhsd(dout)
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1, keepdim=True).contiguous()
        dq = torch.zeros_like(qt, dtype=torch.float32)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kc, vc = k, v
        for hop in range(n):
            owner = (my - hop) % n
            ring_bwd_hop(qt, _bhsd(kc), _bhsd(vc), do, lse, delta,
                         (dq, _bhsd(dk), _bhsd(dv)), my * seq, owner * seq,
                         **kw)
            if hop < n - 1:
                kc, vc, dk, dv = rotate((kc, vc, dk, dv), group)
            else:   # the last hop's accumulators go home; kv is not read
                dk, dv = rotate((dk, dv), group)
        return (_bhsd(dq).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None, None)


def ring_lockstep(q, k, v, dout, n: int, *, causal: bool,
                  scale: Optional[float] = None, ops: HopOps = HOP_KERNELS):
    """The flash ring of ``n`` ranks run in lockstep on one device, for
    checking the hops where there is one card: ``q``, ``k``, ``v`` and
    the output cotangent ``dout`` are whole sequences ``[b, S, h, d]``,
    rank ``r`` holding block ``r`` of ``n``.  Each hop every virtual rank
    runs :func:`ring_fwd_hop` (then :func:`ring_bwd_hop`) on the kv shard
    it holds, and where :class:`_RingFlash` rotates, the held shards (and
    their dk, dv) roll one rank on.  Returns ``(out, dq, dk, dv)`` of the
    whole sequence, ``[b, S, h, d]``: out in q's dtype, the gradients in
    float32."""
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} is not divisible by {n}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, scale=scale, ops=ops)
    seq = q.shape[1] // n

    def blocks(x):
        return [_bhsd(b) for b in x.split(seq, dim=1)]

    qs, dos = blocks(q), blocks(dout)
    held = list(zip(blocks(k), blocks(v)))            # rank r holds block r
    carries = [ring_carry(qr) for qr in qs]
    for hop in range(n):
        for r in range(n):
            ring_fwd_hop(qs[r], *held[r], carries[r], r * seq,
                         ((r - hop) % n) * seq, **kw)
        held = held[-1:] + held[:-1]                  # rank r gets r - 1's
    outs, lses = zip(*(ring_finish(c, q.dtype) for c in carries))
    deltas = [(d.float() * o.float()).sum(-1, keepdim=True).contiguous()
              for d, o in zip(dos, outs)]
    dqs = [torch.zeros_like(qr, dtype=torch.float32) for qr in qs]
    held = [(kr, vr, torch.zeros_like(kr, dtype=torch.float32),
             torch.zeros_like(vr, dtype=torch.float32))
            for kr, vr in held]
    for hop in range(n):
        for r in range(n):
            kr, vr, dkr, dvr = held[r]
            ring_bwd_hop(qs[r], kr, vr, dos[r], lses[r], deltas[r],
                         (dqs[r], dkr, dvr), r * seq, ((r - hop) % n) * seq,
                         **kw)
        held = held[-1:] + held[:-1]
    # after n rolls every shard and its gradients are home again

    def whole(parts):
        return torch.cat([_bhsd(p) for p in parts], dim=1)

    return (whole(outs), whole(dqs), whole([h[2] for h in held]),
            whole([h[3] for h in held]))


def ring_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None, impl: str = "xla",
                   axis: Axis = None):
    """Attention over a sequence sharded across the ranks of ``axis``.

    ``q``, ``k``, ``v``: this rank's shards ``[batch, seq_local, heads,
    head_dim]``; the global sequence is ``seq_local · n`` and rank ``r``
    of the axis owns positions ``[r·seq_local, (r+1)·seq_local)``.
    ``causal`` masks in global positions; ``scale`` defaults to
    ``1/sqrt(head_dim)``.  ``impl``: ``"xla"`` (torch ops, autograd
    through the rotation) or ``"flash"`` (the reference's ``"pallas"``:
    K2-K4 per hop, the gradients rotating with their shards).  Returns this rank's
    output shard, same shape and dtype as ``q``."""
    group = axis_group(axis)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "flash":
        return _RingFlash.apply(q, k, v, group, bool(causal), float(scale))
    if impl != "xla":
        raise ValueError(f"unknown impl {impl!r} (want 'xla' or 'flash')")
    return _ring_xla(q, k, v, causal=causal, scale=scale, group=group)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------
def _to_heads(x, group):
    """``lax.all_to_all(split_axis=2, concat_axis=1, tiled=True)``: rank
    ``j`` gets heads ``[j·h/n, (j+1)·h/n)`` of every rank, the sequence
    concatenated in rank order."""
    n = dist.get_world_size(group)
    b, s, h, d = x.shape
    blocks = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(blocks, group)            # [n(src), b, s, h/n, d]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _to_seq(x, group):
    """The inverse: split the sequence into ``n`` blocks (block ``j`` to
    rank ``j``), concatenate the heads in rank order."""
    n = dist.get_world_size(group)
    b, sg, hn, d = x.shape
    blocks = x.reshape(b, n, sg // n, hn, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(blocks, group)            # [n(src), b, s, h/n, d]
    return got.permute(1, 2, 0, 3, 4).reshape(b, sg // n, n * hn, d)


def ulysses_attention(q, k, v, *, causal: bool = False,
                      scale: Optional[float] = None, impl: str = "xla",
                      axis: Axis = None):
    """All-to-all ("Ulysses") sequence parallelism: ``[batch, seq_local,
    heads, head_dim]`` shards with ``heads`` divisible by the axis size
    are exchanged to ``[batch, seq_global, heads / n, head_dim]``, full
    attention runs on this rank's heads (``impl="flash"``, the
    reference's ``"pallas"``: :func:`flash_attention`, K2-K4; ``"xla"``:
    ``softmax_attention``), and a second exchange restores sequence sharding.  Both exchanges are
    differentiable (backward: the inverse exchange)."""
    group = axis_group(axis)
    n = dist.get_world_size(group)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"heads {h} not divisible by ranks {n}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (_to_heads(t, group) for t in (q, k, v))
    if impl == "flash":
        oh = fa.flash_attention(qh, kh, vh, causal=causal, scale=scale)
    elif impl == "xla":
        oh = fa.softmax_attention(qh, kh, vh, causal=causal, scale=scale)
    else:
        raise ValueError(f"unknown impl {impl!r} (want 'xla' or 'flash')")
    return _to_seq(oh, group).to(q.dtype)
