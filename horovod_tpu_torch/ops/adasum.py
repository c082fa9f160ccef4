"""Adasum: scale-invariant adaptive summation of gradients, the port of
``horovod_tpu/ops/adasum.py``.

Merging two gradients a, b uses

    a' = (1 - <a,b> / (2 |a|^2)) * a  +  (1 - <a,b> / (2 |b|^2)) * b

over a binary tree of ranks (distance doubling: the partner at level k
is ``rank ^ 2^k``).  As in the reference, each level exchanges *whole*
vectors with the partner (``dist.batch_isend_irecv``), so both members
of a pair hold the same result and no gather is needed at the end.  The
dot products are float32 whatever the input type, and both members of a
pair order the operands canonically by the parity of their position at
that level, so they compute bit-identical results.

:func:`adasum_allreduce` also runs over a process set (non-members pass
through) and hierarchically: a plain SUM reduce-scatter inside the node,
VHDD across nodes on each local shard with full-vector dots (the
partial dots summed over the local group), then an all-gather inside
the node.  Adasum needs a power-of-two count of ranks (of nodes,
hierarchically); one rank is the identity.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .. import core


def _adasum_combine(a, b, dot, na2, nb2):
    """The coefficient merge of float32 ``a`` and ``b``, guarded as the
    reference guards it (a zero-norm operand merges as a plain sum)."""
    ca = 1.0 - dot / torch.clamp_min(2.0 * na2, 1e-30)
    cb = 1.0 - dot / torch.clamp_min(2.0 * nb2, 1e-30)
    ca = torch.where(na2 == 0, 1.0, ca)
    cb = torch.where(nb2 == 0, 1.0, cb)
    return ca * a.float() + cb * b.float()


def _exchange(a: torch.Tensor, partner: int) -> torch.Tensor:
    """``a`` sent to the global rank ``partner``, whose ``a`` comes
    back."""
    b = torch.empty_like(a)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, a, partner),
                                        dist.P2POp(dist.irecv, b, partner)]):
        work.wait()
    return b


def _vhdd(tensor: torch.Tensor, n: int, pos: int,
          partner_at: Callable[[int], int],
          dot_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
          ) -> torch.Tensor:
    """The distance-doubling recursion of the flat, process-set and
    hierarchical variants.  ``pos``: this rank's position in the group of
    ``n``; ``partner_at(level)``: the global rank of its partner at a
    level; ``dot_reduce``, when given, sums the partial ``[dot, |a|²,
    |b|²]`` over the ranks sharding the vector."""
    a = tensor.contiguous()
    level = 1
    while level < n:
        b = _exchange(a, partner_at(level))
        af, bf = a.float(), b.float()
        dots = torch.stack([torch.sum(af * bf), torch.sum(af * af),
                            torch.sum(bf * bf)])
        if dot_reduce is not None:
            dots = dot_reduce(dots)
        dot, na2, nb2 = dots[0], dots[1], dots[2]
        if (pos // level) % 2 == 0:
            merged = _adasum_combine(af, bf, dot, na2, nb2)
        else:
            merged = _adasum_combine(bf, af, dot, nb2, na2)
        a = merged.to(tensor.dtype)
        level *= 2
    return a


def _check_pow2(n: int, what: str) -> None:
    if n & (n - 1):
        raise ValueError(f"Adasum requires a power-of-two {what}, got {n}")


def adasum_allreduce(tensor: torch.Tensor, *, process_set=None,
                     hierarchical: bool = False) -> torch.Tensor:
    """Adasum-allreduce ``tensor`` across the job's ranks (a power of two
    of them), over ``process_set``'s ranks, or hierarchically."""
    if hierarchical:
        if process_set is not None:
            raise NotImplementedError(
                "hierarchical Adasum over a process subset")
        return _hierarchical_adasum(tensor)
    if process_set is not None:
        k = process_set.size()
        _check_pow2(k, "rank count")
        member, pos = process_set.member_position()
        process_set.group()  # a set of an earlier world raises here
        if k == 1 or not member:
            return tensor
        ranks = process_set.ranks
        return _vhdd(tensor, k, pos, lambda level: ranks[pos ^ level])
    n = core.size()
    _check_pow2(n, "rank count")
    if n == 1:
        return tensor
    r = core.rank()
    return _vhdd(tensor, n, r, lambda level: r ^ level)


def _hierarchical_adasum(tensor: torch.Tensor) -> torch.Tensor:
    """Local SUM reduce-scatter, cross VHDD on the shards with the
    full-vector dots, local all-gather: the reference's 2-D mesh and
    flat forms in one (the port has one rank line)."""
    from ..parallel import hierarchical as hier

    ls, cross_n = core.local_size(), core.cross_size()
    _check_pow2(cross_n, "node count")
    if cross_n == 1 or ls == 1:
        # one node: the cross stage is empty and what is left is the
        # local sum; one rank per node: VHDD over the nodes
        if ls == 1:
            return adasum_allreduce(tensor)
        out = tensor.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out
    groups = hier.groups()
    flat, pad = hier._flat_padded(tensor, ls)
    shard = hier._scatter_local(flat, ls, groups.local)
    node, chunk = divmod(core.rank(), ls)

    def dot_reduce(v):
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=groups.local)
        return v

    shard = _vhdd(shard, cross_n, node,
                  lambda level: (node ^ level) * ls + chunk,
                  dot_reduce=dot_reduce)
    out = hier._gather_local(shard, flat.shape[0], groups.local)
    if pad:
        out = out[:-pad]
    return out.reshape(tensor.shape)
