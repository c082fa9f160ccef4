"""Collectives on the job's process group: the part of
``horovod_tpu/ops/collectives.py`` this slice uses — ``allreduce`` (the
reported loss) and ``broadcast`` (initial parameters).  The others come
in a later slice."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .. import core
from ..core import Adasum, Average, Max, Min, Sum
from .compression import Compression

_REDUCE_OPS = {Average: dist.ReduceOp.SUM, Sum: dist.ReduceOp.SUM,
               Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX}


def reduce_op(op: str):
    """The ``torch.distributed`` op for a Horovod op name (Average sums,
    then the caller divides by the group size)."""
    if op == Adasum:
        raise NotImplementedError(
            "Adasum is not ported yet (it comes with the wire-tier slice)")
    try:
        return _REDUCE_OPS[op]
    except KeyError:
        raise ValueError(f"unknown reduce op: {op!r}") from None


def allreduce(tensor: torch.Tensor, *, op: str = Average,
              name: Optional[str] = None,
              compression=Compression.none) -> torch.Tensor:
    """Every rank gets the reduction of all ranks' ``tensor``; the input
    is left unchanged."""
    del name  # the reference's tensor name; NCCL calls carry none
    dist_op = reduce_op(op)
    out, ctx = compression.compress(tensor)
    out = out.clone()
    dist.all_reduce(out, op=dist_op)
    if op == Average:
        out = out / core.size()
    return compression.decompress(out, ctx)


def broadcast_(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """``root_rank``'s value into ``tensor`` on every rank, in place."""
    dist.broadcast(tensor, src=root_rank)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0, *,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank receives ``root_rank``'s value; the input is left
    unchanged."""
    del name
    return broadcast_(tensor.clone(), root_rank)
