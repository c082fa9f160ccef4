"""The process plane: one value per process, reduced, gathered or
broadcast across the job — the part of ``horovod_tpu/eager.py`` the
Horovod torch frontend and the callbacks stand on, over
``torch.distributed``.

* :func:`broadcast_object` / :func:`allgather_object` — picklable
  objects (``dist.broadcast_object_list`` / ``all_gather_object``);
* :func:`process_allreduce` / :func:`process_allgather` /
  :func:`process_broadcast` — numpy arrays, carried as tensors on this
  rank's device (NCCL on a card, gloo on the CPU).  Every rank first
  agrees on the arrays' shapes and dtypes (a small object allgather),
  so a mismatch raises the same error on every rank instead of hanging
  the job;
* :func:`normalize_op` — the reference's ``average`` / ``op`` rule.

Each array collective is traced as the reference's host plane traces
it: the shape agreement is the port's negotiation, under a
``NEGOTIATE_<OP>`` span of the timeline, and the collective itself runs
under a span named after the call's tensor (``name``, or a sequential
default name) with the transport's activity (``MESH_ALLREDUCE``, ...:
``torch.distributed`` is one device collective across the processes,
the reference's XLA process mesh), recorded in the metrics plane with
``metrics.record_host`` (``transport="mesh"``).  A broadcast gets its
spans but no metrics, as the reference's mesh broadcast (an object
broadcast) records none.

The reference's device-plane mode (a list of per-rank values handed to
one controller) has no counterpart here: one process drives one card,
so each process holds only its own value (``ROADMAP.md``).

One process: every function is the identity.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import core, metrics
from .core import Adasum, Average, Max, Min, Sum
from .elastic import heartbeat as _heartbeat
from .runtime.stall_inspector import inspector
from .timeline.timeline import timeline

_OPS = {Average: dist.ReduceOp.SUM, Sum: dist.ReduceOp.SUM,
        Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX}


def broadcast_object(obj: Any, root_rank: int = 0, *,
                     name: Optional[str] = None) -> Any:
    """``root_rank``'s picklable ``obj`` on every process.  ``name`` is
    the reference's label of the call; torch's calls carry none."""
    del name
    if core.process_size() == 1:
        return obj
    box = [obj if core.process_rank() == root_rank else None]
    dist.broadcast_object_list(box, src=root_rank, device=core.device())
    return box[0]


def allgather_object(obj: Any, *, name: Optional[str] = None) -> List[Any]:
    """Every process's picklable ``obj``, in rank order."""
    del name
    if core.process_size() == 1:
        return [obj]
    out: List[Any] = [None] * core.process_size()
    dist.all_gather_object(out, obj)
    return out


_seq = itertools.count(1)


def next_name(prefix: str) -> str:
    """Sequential default tensor names, the same on every process when
    the calls are issued in the same order (the reference's
    ``eager_controller.next_name``)."""
    return f"{prefix}.{next(_seq)}"


@contextlib.contextmanager
def _host_guard(name: str, activity: str, op: str, transport: str,
                nbytes: int):
    """The abort seam, the stall watchdog, the timeline span and the
    metrics of one host-plane collective (the reference's
    ``eager._host_guard``, with the abort check of its
    ``_dispatch_guard``: a coordinated abort raises here, before this
    rank enters a collective its dead peer will never join)."""
    _heartbeat.maybe_raise_abort()
    mon = metrics.on()
    t0 = time.perf_counter() if mon else 0.0
    try:
        with inspector.watch(name), timeline.span(name, activity):
            yield
    finally:
        if mon:
            metrics.record_host(op, transport, nbytes,
                                time.perf_counter() - t0)


def _agree_meta(arr: np.ndarray, nm: str, opname: str) -> List[tuple]:
    """The gathered shapes of every rank's ``arr``, under a
    ``NEGOTIATE_<OP>`` span of the timeline; raises the same ValueError
    on every rank when the dtypes differ."""
    op = opname.replace("process_", "").upper()
    timeline.negotiate_start(nm, op)
    try:
        metas = allgather_object((tuple(arr.shape), str(arr.dtype)),
                                 name=nm)
    finally:
        timeline.negotiate_end(nm, op)
    dtypes = [m[1] for m in metas]
    if len(set(dtypes)) > 1:
        raise ValueError(f"{opname} dtype mismatch across ranks: {dtypes}")
    return [tuple(m[0]) for m in metas]


def process_allreduce(arr, *, op: str = Average,
                      name: Optional[str] = None) -> np.ndarray:
    """The reduction (Average, Sum, Min, Max or Adasum) of one numpy
    array per process; the result has the input's dtype."""
    arr = np.asarray(arr)
    if op not in _OPS and op != Adasum:
        raise ValueError(f"unknown reduction op {op!r}")
    if core.process_size() == 1:
        return arr
    nm = name or next_name("process_allreduce")
    shapes = _agree_meta(arr, nm, "process_allreduce")
    if len(set(shapes)) > 1:
        raise ValueError(
            f"process_allreduce shape mismatch across ranks: {shapes}")
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(core.device())
    with _host_guard(nm, "MESH_ALLREDUCE", "allreduce", "mesh", arr.nbytes):
        if op == Adasum:
            from .ops.adasum import adasum_allreduce

            out = adasum_allreduce(t)
        else:
            out = t.clone()
            dist.all_reduce(out, op=_OPS[op])
            if op == Average:
                out = out / core.process_size()
        out = out.cpu().numpy()
    return out.astype(arr.dtype, copy=False)


def process_allgather(arr, *, name: Optional[str] = None) -> np.ndarray:
    """Every process's numpy array concatenated along axis 0, in rank
    order; the first dimensions may differ."""
    arr = np.asarray(arr)
    if core.process_size() == 1:
        return arr
    nm = name or next_name("process_allgather")
    shapes = _agree_meta(arr, nm, "process_allgather")
    if len({len(s) for s in shapes}) > 1 or \
            any(s[1:] != shapes[0][1:] for s in shapes):
        raise ValueError(
            "process_allgather shape mismatch across ranks (all dims but "
            f"the first must agree): {shapes}")
    if not shapes[0]:
        raise ValueError("process_allgather needs arrays of rank >= 1")
    rows = [s[0] for s in shapes]
    padded = np.zeros((max(rows),) + shapes[0][1:], arr.dtype)
    padded[:arr.shape[0]] = arr
    t = torch.from_numpy(padded).to(core.device())
    out = torch.empty((len(rows) * t.shape[0], *t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    with _host_guard(nm, "MESH_ALLGATHER", "allgather", "mesh", arr.nbytes):
        dist.all_gather_into_tensor(out, t)
        out = out.cpu().numpy().reshape((len(rows),) + padded.shape)
    return np.concatenate([out[i, :n] for i, n in enumerate(rows)], axis=0)


def process_broadcast(arr, root_rank: int = 0, *,
                      name: Optional[str] = None) -> np.ndarray:
    """``root_rank``'s numpy array on every process (its shape and dtype
    sent first, so the others need not know them)."""
    arr = np.asarray(arr)
    if core.process_size() == 1:
        return arr
    nm = name or next_name("process_broadcast")
    timeline.negotiate_start(nm, "BROADCAST")
    try:
        shape, dtype = broadcast_object((arr.shape, arr.dtype), root_rank,
                                        name=nm)
    finally:
        timeline.negotiate_end(nm, "BROADCAST")
    src = arr if core.process_rank() == root_rank \
        else np.zeros(shape, dtype)
    t = torch.from_numpy(np.ascontiguousarray(src)).to(core.device())
    # a span, but no metrics: the reference's mesh broadcast records none
    with timeline.span(nm, "MESH_BROADCAST"):
        dist.broadcast(t, src=root_rank)
        out = t.cpu().numpy()
    return out


def normalize_op(average, op):
    """The reference's ``handle_average_backwards_compatibility``: at
    most one of ``average`` and ``op``; Average by default."""
    if average is not None and op is not None:
        raise ValueError("cannot specify both average and op")
    if op is not None:
        return op
    if average is False:
        return Sum
    return Average
