"""Named mesh axes and the differentiable collectives over them: the
port's counterpart of the ``shard_map`` regions the reference's
model-parallel modules run in.

The reference's ring attention, tensor, pipeline and expert parallelism
name a mesh axis (``"sp"``, ``"tp"``, ``"pp"``, ``"ep"``) and XLA finds
the devices along it in the enclosing region.  Here a rank is a process,
so an axis is the ``torch.distributed`` group of the ranks that share
every other mesh coordinate:

* :func:`make_mesh` builds the grid with ``init_device_mesh``, row-major
  as the reference's ``Mesh(devices.reshape(shape), names)``;
* ``with use_mesh(mesh):`` makes its dimension names resolvable, as a
  ``shard_map`` over that mesh does;
* :func:`axis_group` resolves an ``axis`` argument: ``None`` is the
  world (or the one axis of a 1-D mesh in use), a name is that
  dimension of the mesh in use, a ``ProcessGroup`` is itself.

The collectives are ``torch.autograd.Function``s whose backward is the
transpose the reference's autodiff derives: :func:`ppermute` (one
``batch_isend_irecv`` a call; backward the inverse rotation),
:func:`all_to_all` (backward the same exchange), :func:`psum_forward`
(all-reduce forward, identity backward: the transpose of a ``psum``
under ``check_vma=True``, Megatron's g) and :func:`psum_backward`
(identity forward, all-reduce backward: the implicit ``pvary``, Megatron's
f).  On a group of one each is the identity and communicates nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import core

#: the mesh whose dimension names an ``axis`` argument resolves against
_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "horovod_tpu_torch_mesh", default=None)

Axis = Union[None, str, dist.ProcessGroup]


def make_mesh(shape: Sequence[int], names: Sequence[str]) -> DeviceMesh:
    """The ranks of this world, on this rank's device type, as a grid of
    ``shape`` with dimension ``names``; rank ``r`` sits at the row-major
    position ``r`` as device ``r`` of the reference's
    ``devices.reshape(shape)``.  Every rank must call it (it makes a
    group per line of each dimension)."""
    return init_device_mesh(core.device().type, tuple(shape),
                            mesh_dim_names=tuple(names))


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Inside, an ``axis`` name is a dimension of ``mesh``."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def axis_group(axis: Axis = None) -> dist.ProcessGroup:
    """The process group of ``axis`` (see the module docstring)."""
    if isinstance(axis, dist.ProcessGroup):
        return axis
    if not dist.is_initialized():
        raise RuntimeError("model-parallel ops need an initialized world: "
                           "call horovod_tpu_torch.init() first")
    mesh = _MESH.get()
    if axis is None:
        if mesh is None:
            return dist.group.WORLD
        if mesh.ndim != 1:
            raise NotImplementedError(
                "pass axis= to pick the axis of a multi-axis mesh")
        return mesh.get_group()
    if mesh is None:
        raise ValueError(f"axis {axis!r} names no dimension: no mesh is in "
                         "use (with use_mesh(mesh): ...)")
    return mesh.get_group(axis)


# ---------------------------------------------------------------------------
# the collectives, plain
# ---------------------------------------------------------------------------
def _rotate(xs: Sequence[torch.Tensor], group: dist.ProcessGroup,
            shift: int) -> Tuple[torch.Tensor, ...]:
    n = dist.get_world_size(group)
    if shift % n == 0:
        return tuple(xs)
    my = dist.get_rank(group)
    to = dist.get_global_rank(group, (my + shift) % n)
    frm = dist.get_global_rank(group, (my - shift) % n)
    outs, ops = [], []
    for x in xs:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        ops += [dist.P2POp(dist.isend, x.contiguous(), to, group),
                dist.P2POp(dist.irecv, out, frm, group)]
        outs.append(out)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(outs)


def rotate(xs: Sequence[torch.Tensor],
           group: dist.ProcessGroup) -> Tuple[torch.Tensor, ...]:
    """``lax.ppermute(perm=[(i, i + 1 mod n)])`` of each tensor: sent to
    the next rank along the group, received from the previous one, all in
    one ``batch_isend_irecv``.  The received tensors are new contiguous
    buffers.  The identity, with no message, on a group of one."""
    return _rotate(xs, group, 1)


def _all_to_all(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _all_reduce(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


# ---------------------------------------------------------------------------
# differentiable
# ---------------------------------------------------------------------------
class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return rotate(xs, group)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_rotate(grads, ctx.group, -1))


def ppermute(xs: Sequence[torch.Tensor],
             group: dist.ProcessGroup) -> Tuple[torch.Tensor, ...]:
    """:func:`rotate`, differentiable: the backward rotates the gradients
    back one rank, so every rank that ran the forward rotation runs its
    backward too (a rank that drops a rotation from its graph leaves its
    neighbour waiting)."""
    if dist.get_world_size(group) == 1:
        return tuple(xs)
    return _PPermute.apply(group, *xs)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The untiled ``lax.all_to_all(split_axis=0, concat_axis=0)``: ``x``'s
    dim 0 has the group's size, block ``j`` goes to rank ``j`` and the
    block from rank ``j`` lands at ``j``.  The exchange is its own
    inverse, so it is its own backward."""
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all wants dim 0 of the group's size "
                         f"{dist.get_world_size(group)}, got {tuple(x.shape)}")
    return x if dist.get_world_size(group) == 1 else _AllToAll.apply(x, group)


class _PsumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PsumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def psum_forward(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Sum over the group forward, identity backward: a ``psum`` whose
    result every rank then uses alike (its transpose under the
    reference's ``check_vma=True`` is a ``pbroadcast``).  A plain
    all-reduce backward would count the cotangent once per rank."""
    return x if dist.get_world_size(group) == 1 else _PsumForward.apply(x, group)


def psum_backward(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Identity forward, sum over the group backward: a value the ranks
    hold alike, entering per-rank work whose gradients differ (the
    reference's implicit ``pvary``)."""
    return x if dist.get_world_size(group) == 1 else _PsumBackward.apply(x, group)
