"""horovod_tpu_torch.torch: the Horovod torch API, the port of
``horovod_tpu/torch/__init__.py``.

The reference bridges torch tensors to its XLA data plane through numpy
and a thread pool; here torch tensors ride ``torch.distributed`` itself
(NCCL on a card, gloo on the CPU), as the reference Horovod rides NCCL.
The handle API stays: ``allreduce_async`` and its kin return an integer
handle over a ``torch.distributed`` ``Work`` (an ``async_op`` call),
``poll`` asks whether it is done and ``synchronize`` waits for it and
returns the result.  The reference's thread pool has no counterpart:
the ``Work`` is the deferred operation.

``DistributedOptimizer`` wraps a ``torch.optim`` optimizer: each
parameter's gradient is all-reduced asynchronously as soon as it is
final for the backward (``register_post_accumulate_grad_hook``), after
``backward_passes_per_step`` passes, and ``step`` joins the handles
before the wrapped step.  With ``op=Adasum`` the wrapper reduces each
parameter's *delta* of the local step instead.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from .. import core, eager
from ..core import Adasum, Average, Max, Min, Sum  # noqa: F401
from ..ops import collectives
from ..ops.compression import (  # noqa: F401
    Compression, average_, check_wire, compress_with,
)

init = core.init
shutdown = core.shutdown
rank = core.rank
local_rank = core.local_rank
size = core.size
local_size = core.local_size
cross_rank = core.cross_rank
cross_size = core.cross_size
is_initialized = core.is_initialized
mpi_enabled = core.mpi_enabled
nccl_built = core.nccl_built

_normalize_op = eager.normalize_op


class HandleManager:
    """Integer handles of outstanding operations: each a
    ``torch.distributed`` ``Work`` (None when the operation already ran)
    and the function that finishes it into its result."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0
        self._ops: Dict[int, Tuple[Any, Callable]] = {}

    def add(self, work, finish: Callable) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._ops[h] = (work, finish)
        return h

    def _get(self, handle: int, pop: bool):
        with self._lock:
            entry = self._ops.pop(handle, None) if pop \
                else self._ops.get(handle)
        if entry is None:
            raise ValueError(f"unknown handle {handle}")
        return entry

    def take(self, handle: int) -> Tuple[Any, Callable]:
        """The handle's ``(work, finish)``, the handle consumed."""
        return self._get(handle, pop=True)

    def poll(self, handle: int) -> bool:
        work, _ = self._get(handle, pop=False)
        return work is None or work.is_completed()

    def wait(self, handle: int) -> Any:
        work, finish = self.take(handle)
        if work is not None:
            work.wait()
        return finish()


_handles = HandleManager()


def _own(c: torch.Tensor, tensor: torch.Tensor) -> torch.Tensor:
    """``c`` as a buffer of the call's own: a copy when it shares
    ``tensor``'s memory (the input is left as it was)."""
    return c.clone() if c.data_ptr() == tensor.data_ptr() else c


def allreduce_async(tensor, average=None, name=None, op=None,
                    compression=Compression.none) -> int:
    """Starts the reduction of ``tensor`` (op Average, Sum, Min, Max or
    Adasum; ``average`` is the older spelling) across the job and
    returns its handle.  Average is a SUM, then a division."""
    del name
    op = _normalize_op(average, op)
    t = tensor.detach()
    if op == Adasum:
        out = collectives.allreduce(t, op=Adasum, compression=compression)
        return _handles.add(None, lambda: out)
    dist_op = collectives.reduce_op(op)
    n = core.size()
    c, ctx = compress_with(compression, t, n)
    check_wire(c.dtype, c.device)
    buf = _own(c, t)
    work = dist.all_reduce(buf, op=dist_op, async_op=True)

    def finish():
        out = average_(buf, n) if op == Average else buf
        return compression.decompress(out, ctx)

    return _handles.add(work, finish)


def allreduce(tensor, average=None, name=None, op=None,
              compression=Compression.none):
    return synchronize(allreduce_async(tensor, average, name, op,
                                       compression))


def allreduce_async_(tensor, average=None, name=None, op=None) -> int:
    """:func:`allreduce_async` whose result goes into ``tensor``."""
    work, finish = _handles.take(allreduce_async(tensor, average, name, op))
    return _handles.add(work, lambda: tensor.copy_(finish()))


def allreduce_(tensor, average=None, name=None, op=None):
    """In place: ``tensor`` takes the reduction."""
    return synchronize(allreduce_async_(tensor, average, name, op))


def allgather_async(tensor, name=None) -> int:
    """Starts the gather of every rank's ``tensor`` along axis 0 (the
    first dimensions may differ) and returns its handle."""
    del name
    t = tensor.detach().contiguous()
    n = core.size()
    rows = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    all_rows = torch.empty(n, dtype=torch.int64, device=t.device)
    dist.all_gather_into_tensor(all_rows, rows)
    counts = all_rows.tolist()
    top = max(counts)
    padded = t if t.shape[0] == top else torch.cat(
        [t, t.new_zeros((top - t.shape[0], *t.shape[1:]))])
    out = torch.empty((n * top, *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    work = dist.all_gather_into_tensor(out, padded, async_op=True)

    def finish():
        return torch.cat([out[i * top:i * top + k]
                          for i, k in enumerate(counts)])

    return _handles.add(work, finish)


def allgather(tensor, name=None):
    return synchronize(allgather_async(tensor, name))


def broadcast_async(tensor, root_rank, name=None) -> int:
    """Starts the broadcast of ``root_rank``'s ``tensor`` into a new
    tensor on every rank and returns its handle."""
    del name
    buf = tensor.detach().clone()
    work = dist.broadcast(buf, src=root_rank, async_op=True)
    return _handles.add(work, lambda: buf)


def broadcast(tensor, root_rank, name=None):
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_async_(tensor, root_rank, name=None) -> int:
    """:func:`broadcast_async` into ``tensor`` itself."""
    del name
    with torch.no_grad():
        work = dist.broadcast(tensor.data, src=root_rank, async_op=True)
    return _handles.add(work, lambda: tensor)


def broadcast_(tensor, root_rank, name=None):
    return synchronize(broadcast_async_(tensor, root_rank, name))


def poll(handle: int) -> bool:
    """Whether the operation behind ``handle`` has completed."""
    return _handles.poll(handle)


def synchronize(handle: int):
    """Waits for the operation behind ``handle``; returns its result.  A
    handle is consumed by its synchronize."""
    return _handles.wait(handle)


def join() -> int:
    from ..elastic.join import join as _join

    return _join()


# ---------------------------------------------------------------------------
# the optimizers and the start-up broadcasts
# ---------------------------------------------------------------------------
class _DistributedOptimizer:
    """Wraps a ``torch.optim`` optimizer: each parameter's gradient is
    all-reduced asynchronously once it is final for the backward, every
    ``backward_passes_per_step`` passes, and ``synchronize`` joins the
    handles before ``step`` runs the wrapped step."""

    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1, op=Average):
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self.backward_passes_per_step = backward_passes_per_step
        self._counter = 0
        self._param_names = {}
        self._hooks = []
        self._pending = {}           # param id -> handle
        self._delay = {}             # param id -> backward passes left
        if named_parameters is not None:
            for n, p in named_parameters:
                self._param_names[id(p)] = n
        for group in self._opt.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._delay[id(p)] = backward_passes_per_step
                    self._hooks.append(p.register_post_accumulate_grad_hook(
                        self._hook))

    def _hook(self, p) -> None:
        self._delay[id(p)] -= 1
        if self._delay[id(p)] > 0 or p.grad is None:
            return
        self._delay[id(p)] = self.backward_passes_per_step
        self._pending[id(p)] = allreduce_async(
            p.grad, op=self._op, compression=self._compression)

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def zero_grad(self, *a, **kw):
        return self._opt.zero_grad(*a, **kw)

    def synchronize(self) -> None:
        """Join the outstanding gradient handles; reduce any gradient
        whose hook did not fire (a gradient set by hand)."""
        for group in self._opt.param_groups:
            for p in group["params"]:
                g = p.grad
                if g is None:
                    continue
                h = self._pending.pop(id(p), None)
                if h is None:
                    h = allreduce_async(g, op=self._op,
                                        compression=self._compression)
                with torch.no_grad():
                    g.copy_(_handles.wait(h))

    def step(self, closure=None):
        self._counter += 1
        if self._counter % self.backward_passes_per_step == 0:
            self.synchronize()
            return self._opt.step(closure)
        return None


class _DistributedAdasumOptimizer:
    """Adasum of the parameters' *deltas*: each step keeps the
    parameters, lets the wrapped optimizer take its local step,
    Adasum-reduces ``delta = p_after - start`` across the job and sets
    ``p = start + reduced delta``, so the wrapped optimizer's state
    stays consistent with what was applied."""

    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1):
        self._opt = optimizer
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._counter = 0
        self._param_names = {}
        if named_parameters is not None:
            for n, p in named_parameters:
                self._param_names[id(p)] = n

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def zero_grad(self, *a, **kw):
        return self._opt.zero_grad(*a, **kw)

    def synchronize(self) -> None:
        """Nothing to join: the deltas exist only after the local step."""

    def step(self, closure=None):
        self._counter += 1
        if self._counter % self.backward_passes_per_step != 0:
            return None  # the gradients accumulate locally
        params = [p for g in self._opt.param_groups for p in g["params"]
                  if p.grad is not None]
        starts = [p.detach().clone() for p in params]
        loss = self._opt.step(closure)
        with torch.no_grad():
            for p, start in zip(params, starts):
                reduced = collectives.allreduce(
                    p.detach() - start, op=Adasum,
                    compression=self._compression)
                p.copy_(start + reduced.to(p.dtype))
        return loss


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, op=Average):
    """``op=Adasum`` gives the delta optimizer, any other op the
    gradient-reducing one."""
    if op == Adasum:
        return _DistributedAdasumOptimizer(
            optimizer, named_parameters, compression,
            backward_passes_per_step)
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step, op)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """``root_rank``'s parameters into every rank's, in place (a
    ``state_dict`` or an iterable of ``(name, tensor)``)."""
    items = list(params.items()) if hasattr(params, "items") \
        else list(params)
    for _, p in items:
        if torch.is_tensor(p):
            broadcast_(p, root_rank)


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """``root_rank``'s optimizer state (``state_dict``) loaded into every
    rank's optimizer; each rank's ``load_state_dict`` puts the tensors
    on its parameters' device."""
    state = optimizer.state_dict()
    if core.process_size() > 1:
        state = broadcast_object(_to_cpu(state), root_rank)
    optimizer.load_state_dict(state)


def broadcast_object(obj, root_rank: int = 0, name=None):
    """``root_rank``'s picklable ``obj`` on every rank."""
    return eager.broadcast_object(obj, root_rank=root_rank, name=name)
