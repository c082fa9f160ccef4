"""Join: uneven-data participation, the port of
``horovod_tpu/elastic/join.py``.

A rank that has run out of data still takes part in every allreduce,
with zeros, and the average divides by the number of ranks still
active.  As in the reference, joined-ness is a per-rank boolean input
(``active``) rather than a divergence of the ranks' control flow, so
every rank runs the same step (and the same captured graph).
:func:`join` is the process-level barrier.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import core
from ..core import Average, Sum


def _active(active, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(active, device=like.device).to(torch.bool)


def join_allreduce(tensor: torch.Tensor, active, *,
                   op: str = Average) -> torch.Tensor:
    """Allreduce where a rank with ``active`` false contributes zeros;
    Average divides by the number of active ranks (at least 1).
    ``active``: a bool (or a bool tensor on the device)."""
    if op not in (Average, Sum):
        raise ValueError(f"join_allreduce supports Average/Sum, got {op!r}")
    act = _active(active, tensor)
    total = torch.where(act, tensor, torch.zeros_like(tensor))
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    if op == Sum:
        return total
    return total / torch.clamp_min(join_count(act).float(), 1.0)


def join_count(active) -> torch.Tensor:
    """The number of active (not joined) ranks, an int32 tensor."""
    count = torch.as_tensor(active, device=core.device()).to(
        torch.int32).reshape(1).clone()
    dist.all_reduce(count, op=dist.ReduceOp.SUM)
    return count[0]


def join() -> int:
    """Blocks until every process has called join; returns the last
    rank to join, which the barrier does not tell apart: the highest
    rank, as the reference returns.  One process: its own rank."""
    core._require_init()
    from .. import metrics

    if metrics.on():
        metrics.JOIN_EVENTS.inc()
    if core.process_size() == 1:
        return core.process_rank()
    dist.barrier()
    return core.process_size() - 1
