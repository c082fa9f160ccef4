"""Hierarchical (two-level) collectives, a local stage and a cross stage:
the port of ``horovod_tpu/parallel/hierarchical.py``.

The reference Horovod's NCCLHierarchicalAllreduce on its LOCAL / CROSS
communicator split: a reduce-scatter inside the node, an all-reduce of
the 1/local_size shard across the nodes, an all-gather inside the node.
On a GPU cluster the local groups ride NVLink and the cross groups the
network.  Ranks are laid out as in :mod:`..core`: rank ``node *
local_size + local_rank``.

The local and cross groups are ``torch.distributed`` groups.  Making one
is collective, so :func:`groups` makes every local and every cross group
on every rank, in the same order (each rank also makes the groups it is
not in), once for each world :func:`~horovod_tpu_torch.core.init` joins;
groups made for one world raise when used in the next.
The first collective on a group runs eagerly (the train step's first
call is eager), which sets up its communicator before any CUDA graph
captures it.

:func:`two_level_allreduce` falls back to the flat all-reduce on a
trivial topology or a cross group that is not a power of two; each
fallback is logged and counted in :data:`FALLBACKS`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import core
from ..core import Adasum, Average, Sum
from ..ops.compression import (
    Compression, ErrorFeedback, _compressible, average_, check_wire,
    compress_with,
)
from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

#: two-level reductions that fell back to the flat all-reduce, counted on
#: the host as the calls are issued (a CUDA graph counts its capture
#: once); exported as a metric once the metrics module is ported
FALLBACKS = {"two_level": 0}


def _local_groups() -> list:
    ls = core.local_size()
    return [list(range(n * ls, (n + 1) * ls))
            for n in range(core.cross_size())]


def _cross_groups_for_chunk() -> list:
    ls = core.local_size()
    return [[n * ls + r for n in range(core.cross_size())]
            for r in range(ls)]


class _Groups:
    """This rank's local and cross groups, made for one world: used in
    the next (after :func:`core.reinit`) they raise."""

    def __init__(self, local, cross):
        self.epoch = core.epoch()
        self._local, self._cross = local, cross

    def _check(self) -> None:
        if self.epoch != core.epoch():
            raise RuntimeError(
                "these hierarchical groups were made before "
                "horovod_tpu_torch.reinit(); take them from groups() again")

    @property
    def local(self):
        self._check()
        return self._local

    @property
    def cross(self):
        self._check()
        return self._cross


_groups: Optional[_Groups] = None


def groups() -> _Groups:
    """This rank's local and cross ``torch.distributed`` groups, made on
    the first call in each world: every rank makes every local group,
    then every cross group, in rank order."""
    global _groups
    if _groups is None or _groups.epoch != core.epoch():
        me = core.rank()
        local = cross = None
        for ranks in _local_groups():
            g = dist.new_group(ranks)
            if me in ranks:
                local = g
        for ranks in _cross_groups_for_chunk():
            g = dist.new_group(ranks)
            if me in ranks:
                cross = g
        _groups = _Groups(local, cross)
    return _groups


# ---------------------------------------------------------------------------
# the stage plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DispatchStage:
    """One stage of a hierarchical dispatch: the op kind, the group's
    label and its member ranks."""

    op: str
    group: str
    peers: Tuple[int, ...]


def process_group_members(rank: int, size: int, local_size: int
                          ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local members, cross members) of ``rank`` on the rank line."""
    node, chunk = divmod(rank, local_size)
    local = tuple(range(node * local_size, (node + 1) * local_size))
    cross = tuple(n * local_size + chunk
                  for n in range(size // local_size))
    return local, cross


def process_stage_plan(op: str = "allreduce", *,
                       rank: Optional[int] = None,
                       size: Optional[int] = None,
                       local_size: Optional[int] = None
                       ) -> Optional[List[DispatchStage]]:
    """The groups a two-level collective dispatches to on ``rank``, in
    order; None when the topology is trivial (one host, one process a
    host, or an uneven split) and the dispatch is one flat collective."""
    if rank is None:
        rank = core.process_rank()
    if size is None:
        size = core.process_size()
    if local_size is None:
        local_size = env_util.get_int(env_util.HVD_LOCAL_SIZE, 0) or 1
    if size <= 1 or local_size <= 1 or local_size >= size \
            or size % local_size:
        return None
    local, cross = process_group_members(rank, size, local_size)
    node, chunk = divmod(rank, local_size)
    return [DispatchStage("reducescatter", f"local:{node}", local),
            DispatchStage(op, f"cross:{chunk}", cross),
            DispatchStage("allgather", f"local:{node}", local)]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
def _flat_padded(tensor: torch.Tensor, ls: int):
    flat = tensor.reshape(-1)
    pad = (-flat.shape[0]) % ls
    return (F.pad(flat, (0, pad)) if pad else flat.contiguous()), pad


def _scatter_local(flat: torch.Tensor, ls: int, local) -> torch.Tensor:
    shard = torch.empty(flat.shape[0] // ls, dtype=flat.dtype,
                        device=flat.device)
    dist.reduce_scatter_tensor(shard, flat, op=dist.ReduceOp.SUM,
                               group=local)
    return shard


def _gather_local(shard: torch.Tensor, n: int, local) -> torch.Tensor:
    out = torch.empty(n, dtype=shard.dtype, device=shard.device)
    dist.all_gather_into_tensor(out, shard.contiguous(), group=local)
    return out


def _sum_world(tensor: torch.Tensor) -> torch.Tensor:
    out = tensor.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def hierarchical_allreduce(tensor: torch.Tensor, *, op: str = Average
                           ) -> torch.Tensor:
    """Two-level all-reduce: a SUM reduce-scatter inside the node, a SUM
    all-reduce of the shard across the nodes, an all-gather inside the
    node (padded to a multiple of the local size); Average divides by
    the world's size at the end.  On one node or one rank a node it is
    the flat all-reduce."""
    if op == Adasum:
        from ..ops.adasum import adasum_allreduce

        return adasum_allreduce(tensor, hierarchical=True)
    if op not in (Average, Sum):
        raise ValueError("hierarchical allreduce supports Sum/Average/Adasum")
    ls, cs = core.local_size(), core.cross_size()
    if ls == 1 or cs == 1:
        out = _sum_world(tensor)
    else:
        g = groups()
        flat, pad = _flat_padded(tensor, ls)
        shard = _scatter_local(flat, ls, g.local)
        dist.all_reduce(shard, op=dist.ReduceOp.SUM, group=g.cross)
        full = _gather_local(shard, flat.shape[0], g.local)
        out = (full[:-pad] if pad else full).reshape(tensor.shape)
    return average_(out, core.size()) if op == Average else out


def _count_two_level_fallback(reason: str) -> None:
    FALLBACKS["two_level"] += 1
    log.warning("two_level_allreduce falling back to flat allreduce: %s",
                reason)


def two_level_allreduce(tensor: torch.Tensor, *, op: str = Average,
                        compression=Compression.none) -> torch.Tensor:
    """The two-level all-reduce with the compressed payload on the cross
    stage only:

    1. a SUM reduce-scatter inside the node at full precision;
    2. an all-reduce of the 1/local_size shard across the nodes,
       compressed for ``cross_size`` summands (the scale is the max over
       the whole world, as the reference's ``pmax`` takes it);
    3. an all-gather of the decompressed shard inside the node.

    A trivial topology (one node, or one rank a node) or a cross group
    that is not a power of two falls back to the flat all-reduce,
    compressed for the world's size (logged, counted in FALLBACKS).  An
    :class:`ErrorFeedback` compression gives its inner compressor here:
    the residual is shaped like the whole tensor, the wire error like
    the shard."""
    if op == Adasum:
        from ..ops.adasum import adasum_allreduce

        return adasum_allreduce(tensor, hierarchical=True)
    if op not in (Average, Sum):
        raise ValueError("two_level_allreduce supports Sum/Average/Adasum")
    if isinstance(compression, ErrorFeedback):
        compression = compression.compressor
    ls, cs, n = core.local_size(), core.cross_size(), core.size()

    def _flat():
        c, ctx = compress_with(compression, tensor, n)
        check_wire(c.dtype, c.device)
        out = _sum_world(c)
        if op == Average:
            out = average_(out, n)
        return compression.decompress(out, ctx)

    if ls == 1 or cs == 1:
        _count_two_level_fallback(
            f"trivial topology (local_size={ls}, cross_size={cs})")
        return _flat()
    if cs & (cs - 1):
        _count_two_level_fallback(
            f"cross-host group of {cs} is not a power of two")
        return _flat()
    if not _compressible(tensor):
        return hierarchical_allreduce(tensor, op=op)
    g = groups()
    flat, pad = _flat_padded(tensor, ls)
    shard = _scatter_local(flat, ls, g.local)
    c, ctx = compress_with(compression, shard, cs)
    check_wire(c.dtype, c.device)
    # the shard is this call's own buffer, so reducing it in place is safe
    dist.all_reduce(c, op=dist.ReduceOp.SUM, group=g.cross)
    shard = compression.decompress(c, ctx)
    full = _gather_local(shard, flat.shape[0], g.local)
    out = (full[:-pad] if pad else full).reshape(tensor.shape)
    return average_(out, n) if op == Average else out


def use_two_level_default() -> bool:
    return env_util.get_bool(env_util.HVD_TWO_LEVEL_ALLREDUCE, False)


def use_hierarchical_default() -> bool:
    return env_util.get_bool(env_util.HVD_HIERARCHICAL_ALLREDUCE, False)


def hierarchical_allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Two-level allgather: inside the node, then the node blocks across
    the nodes; every rank's tensor concatenated in rank order (the
    tensors' shapes equal)."""
    ls, cs = core.local_size(), core.cross_size()
    if ls == 1 or cs == 1:
        out = torch.empty((core.size() * tensor.shape[0], *tensor.shape[1:]),
                          dtype=tensor.dtype, device=tensor.device)
        dist.all_gather_into_tensor(out, tensor.contiguous())
        return out
    g = groups()
    local = torch.empty((ls * tensor.shape[0], *tensor.shape[1:]),
                        dtype=tensor.dtype, device=tensor.device)
    dist.all_gather_into_tensor(local, tensor.contiguous(), group=g.local)
    out = torch.empty((cs * local.shape[0], *local.shape[1:]),
                      dtype=tensor.dtype, device=tensor.device)
    dist.all_gather_into_tensor(out, local, group=g.cross)
    return out
