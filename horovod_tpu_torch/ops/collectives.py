"""Collectives on the job's process group: the port of
``horovod_tpu/ops/collectives.py``.

The reference emits each collective over its device mesh inside an SPMD
region; here every rank is a process and each function is one
``torch.distributed`` call on the job's group, or on a
:class:`ProcessSet`'s group (Adasum: a few, ``ops/adasum.py``): NCCL for CUDA tensors, gloo for CPU tensors
(a mixed ``"cpu:gloo,cuda:nccl"`` backend serves both).  Each function
leaves its input unchanged and returns a new tensor.  None of them reads
a value back to the host, so they can be captured into a CUDA graph.
Each records itself in the traced-collective inventory
(``metrics.record_traced``): inside a train step once a capture, as the
reference records once a trace; outside one, every call.

A rank outside the ``process_set`` it is given takes part in nothing and
gets its input back (a copy).  The reference leaves that value to its
XLA grouping (the complement ranks reduce among themselves) and its
callers ignore it; the port defines it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import core
from .. import metrics as _metrics
from ..core import Adasum, Average, Max, Min, Sum
from .compression import Compression, average_, check_wire, compress_with

_REDUCE_OPS = {Average: dist.ReduceOp.SUM, Sum: dist.ReduceOp.SUM,
               Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX}


def reduce_op(op: str):
    """The ``torch.distributed`` op for a Horovod op name (Average sums,
    then the caller divides by the group size).  Adasum is no
    ``torch.distributed`` op: :func:`allreduce` runs it tensor by tensor
    (``ops/adasum.py``)."""
    if op == Adasum:
        raise ValueError(
            "Adasum is not a bucketed reduction: reduce each tensor with "
            "allreduce(op=Adasum)")
    try:
        return _REDUCE_OPS[op]
    except KeyError:
        raise ValueError(f"unknown reduce op: {op!r}") from None


class ProcessSet:
    """A subset of ranks forming their own collective group (reference
    ``ProcessSet``, Horovod's restricted communicator).

    Its ``torch.distributed`` group is made when the set is constructed,
    which is itself collective: every rank of the job constructs the same
    sets in the same order, members or not.  A set made for one world
    (see :func:`core.reinit`) raises when used in the next."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks = tuple(sorted(int(r) for r in ranks))
        if not self.ranks:
            raise ValueError("process set must contain at least one rank")
        if len(set(self.ranks)) != len(self.ranks):
            raise ValueError("duplicate ranks in process set")
        if self.ranks[0] < 0 or self.ranks[-1] >= core.size():
            raise ValueError(f"process set ranks {self.ranks} exceed world "
                             f"size {core.size()}")
        self._epoch = core.epoch()
        self._group = dist.new_group(list(self.ranks))

    def size(self) -> int:
        return len(self.ranks)

    def member_position(self) -> Tuple[bool, int]:
        """(whether this rank is in the set, its position there; the set's
        size for a rank outside it)."""
        r = core.rank()
        if r in self.ranks:
            return True, self.ranks.index(r)
        return False, self.size()

    def group(self):
        """The set's ``torch.distributed`` group."""
        if self._epoch != core.epoch():
            raise RuntimeError("this process set was made before "
                               "horovod_tpu_torch.reinit(); make it again")
        return self._group


def group_of(process_set: Optional[ProcessSet]):
    """``(member, group, group size)``: whether this rank takes part in a
    call over ``process_set`` (the whole job when None), the group to
    call on and its size."""
    if process_set is None:
        return True, None, core.size()
    group = process_set.group()
    return process_set.member_position()[0], group, process_set.size()


# --------------------------------------------------------------------------
# allreduce
# --------------------------------------------------------------------------
def allreduce(tensor: torch.Tensor, *, op: str = Average,
              name: Optional[str] = None, compression=Compression.none,
              process_set: Optional[ProcessSet] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              hierarchical: bool = False,
              two_level: bool = False) -> torch.Tensor:
    """Every rank of the group gets the reduction of its ranks'
    ``tensor`` (``op``: Average, Sum, Adasum, Min or Max), scaled by
    ``prescale_factor`` before the wire cast and by ``postscale_factor``
    after the reduction, as in the reference.  ``compression`` compresses
    for the group's size (a quantizer's scale is one MAX all-reduce over
    the group).  ``hierarchical`` takes the two-level local / cross
    decomposition (``parallel/hierarchical.py``), ``two_level`` the one
    with ``compression`` on the cross stage only."""
    del name  # the reference's tensor name; NCCL calls carry none
    # once a capture inside a train step (metrics.traced_recording)
    _metrics.record_traced("allreduce", tensor)
    if two_level and op in (Average, Sum, Adasum):
        if process_set is not None:
            raise ValueError(
                "two-level allreduce over a process subset is unsupported")
        from ..parallel.hierarchical import two_level_allreduce

        t = tensor * prescale_factor if prescale_factor != 1.0 else tensor
        out = two_level_allreduce(t, op=op, compression=compression)
        return out * postscale_factor if postscale_factor != 1.0 else out
    if hierarchical and op in (Min, Max):
        raise ValueError("hierarchical allreduce supports Sum/Average/Adasum")
    if op != Adasum:
        dist_op = reduce_op(op)
    if hierarchical and process_set is not None:
        raise ValueError(
            "hierarchical allreduce over a process subset is unsupported")
    member, group, group_size = group_of(process_set)
    if not member:
        return tensor.clone()
    # prescale before the wire cast: scaling an int8 / fp8 payload would
    # promote its type and move the quantization grid
    if prescale_factor != 1.0:
        tensor = tensor * prescale_factor
    out, ctx = compress_with(compression, tensor, group_size, group=group)
    check_wire(out.dtype, out.device)
    if op == Adasum:
        from .adasum import adasum_allreduce

        out = adasum_allreduce(out, process_set=process_set,
                               hierarchical=hierarchical)
    elif hierarchical:
        from ..parallel.hierarchical import hierarchical_allreduce

        out = hierarchical_allreduce(out, op=op)
    else:
        out = out.clone()
        dist.all_reduce(out, op=dist_op, group=group)
        if op == Average:
            out = average_(out, group_size)
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return compression.decompress(out, ctx)


def grouped_allreduce(tensors: Sequence[torch.Tensor], *, op: str = Average,
                      compression=Compression.none,
                      process_set: Optional[ProcessSet] = None,
                      threshold_bytes: Optional[int] = None):
    """Allreduce a list of tensors as few fused collectives (same-dtype
    buckets under ``threshold_bytes``); returns the list in input
    order."""
    from .fusion import fused_allreduce

    return fused_allreduce(list(tensors), op=op, compression=compression,
                           process_set=process_set,
                           threshold_bytes=threshold_bytes)


def allreduce_gradients(grads, *, op: str = Average,
                        compression=Compression.none):
    """Allreduce every leaf of a gradient tree, fused by dtype buckets."""
    from .fusion import allreduce_pytree

    return allreduce_pytree(grads, op=op, compression=compression)


# --------------------------------------------------------------------------
# allgather
# --------------------------------------------------------------------------
def allgather(tensor: torch.Tensor, *, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along axis 0, in rank order,
    on every rank of the group.  Every rank gives the same shape (for
    varying first dimensions, :func:`allgatherv`)."""
    del name
    _metrics.record_traced("allgather", tensor)
    member, group, group_size = group_of(process_set)
    if not member:
        return tensor.clone()
    out = torch.empty((group_size * tensor.shape[0], *tensor.shape[1:]),
                      dtype=tensor.dtype, device=tensor.device)
    dist.all_gather_into_tensor(out, tensor.contiguous(), group=group)
    return out


def allgatherv(tensor: torch.Tensor, *, valid_rows, max_rows: int,
               process_set: Optional[ProcessSet] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allgather with a varying first dimension, as the reference: each
    rank's first ``valid_rows`` rows (an int or an int tensor on the
    device, so the count need not reach the host) padded to ``max_rows``.
    Returns ``(gathered, row_counts)``: ``gathered`` is ``[size *
    max_rows, ...]`` with the invalid rows zeroed, ``row_counts`` the
    int32 valid counts per rank.  A rank outside ``process_set`` gets
    its own padded rows and count."""
    pad = max_rows - tensor.shape[0]
    padded = torch.cat([tensor, tensor.new_zeros((pad, *tensor.shape[1:]))]) \
        if pad else tensor
    rows = torch.arange(max_rows, device=tensor.device)
    mask = (rows < valid_rows).reshape((max_rows,) + (1,) * (tensor.dim() - 1))
    padded = torch.where(mask, padded, torch.zeros_like(padded))
    counts = valid_rows.to(tensor.device, torch.int32).reshape(1) \
        if torch.is_tensor(valid_rows) else torch.full(
            (1,), int(valid_rows), dtype=torch.int32, device=tensor.device)
    return (allgather(padded, process_set=process_set),
            allgather(counts, process_set=process_set))


# --------------------------------------------------------------------------
# broadcast
# --------------------------------------------------------------------------
def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """``root_rank``'s value into ``tensor`` on every rank of the group,
    in place; a rank outside ``process_set`` keeps its value."""
    _metrics.record_traced("broadcast", tensor)
    member, group, _ = group_of(process_set)
    if process_set is not None and root_rank not in process_set.ranks:
        raise ValueError(f"broadcast root {root_rank} is not in the "
                         f"process set {process_set.ranks}")
    if member:
        dist.broadcast(tensor, src=root_rank, group=group)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0, *,
              name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Every rank of the group receives ``root_rank``'s value (a rank of
    the job, which must be in ``process_set``)."""
    del name
    return broadcast_(tensor.clone(), root_rank, process_set)


# --------------------------------------------------------------------------
# alltoall / reducescatter
# --------------------------------------------------------------------------
def _chunks(tensor: torch.Tensor, n: int, what: str) -> None:
    if tensor.shape[0] % n:
        raise ValueError(f"{what} first dim {tensor.shape[0]} not divisible "
                         f"by {n}")


def alltoall(tensor: torch.Tensor, *,
             process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Equal-split all-to-all: the group's rank i sends its j-th chunk
    along axis 0 to its rank j and receives rank j's i-th chunk there.
    ``tensor.shape[0]`` must divide by the group's size."""
    _metrics.record_traced("alltoall", tensor)
    member, group, group_size = group_of(process_set)
    _chunks(tensor, group_size, "alltoall")
    if not member:
        return tensor.clone()
    out = torch.empty_like(tensor, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, tensor.contiguous(), group=group)
    return out


def reducescatter(tensor: torch.Tensor, *, op: str = Sum,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """The reduction (Sum or Average) of the group's ``tensor``s, cut into
    equal chunks along axis 0: the group's rank i gets chunk i."""
    if op not in (Sum, Average):
        raise ValueError(f"reducescatter takes Sum or Average, got {op!r}")
    _metrics.record_traced("reducescatter", tensor)
    member, group, group_size = group_of(process_set)
    _chunks(tensor, group_size, "reducescatter")
    if not member:
        return tensor.clone()
    out = torch.empty((tensor.shape[0] // group_size, *tensor.shape[1:]),
                      dtype=tensor.dtype, device=tensor.device)
    dist.reduce_scatter_tensor(out, tensor.contiguous(),
                               op=dist.ReduceOp.SUM, group=group)
    if op == Average:
        out = out / group_size
    return out
