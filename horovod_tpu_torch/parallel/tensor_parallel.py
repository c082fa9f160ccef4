"""Tensor (model) parallelism: the port of
``horovod_tpu/parallel/tensor_parallel.py``.

The reference shards a standard model's parameters with sharding
annotations and lets the GSPMD partitioner derive Megatron's f and g.
Here every rank is a process holding its own shard, so they are written
out (``parallel/mesh.py``):

* f, :func:`copy_to_tp` — identity forward, all-reduce backward, at the
  input of a column-parallel product (its rows see the whole input, and
  each rank's gradient of it covers only its columns);
* g, :func:`reduce_from_tp` — all-reduce forward, identity backward,
  after a row-parallel product (each rank holds a partial sum).

:class:`ParallelMLP` is the reference's module (``up``, gelu, ``down``)
with its f and g in place when its parameters are one rank's shard; the
bias after the row product is added once, after g.

Rules map a parameter-name suffix to a spec builder, ``axis -> spec``,
a spec naming for each dim of the port's tensor the axis it is sharded
over (``None``: replicated).  The port's names are ``canonical_params``'
(flax's); its layouts are torch's, so a ``Linear`` weight is ``[out,
in]`` and column parallelism shards its dim 0 where the reference's
``[in, out]`` kernel shards dim 1.

Not ported: the reference's remark that this module is invisible to its
schedule checker (``hvd_verify``); the collectives here are explicit.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..convert import canonical_params
from ..models.layers import Dense
from .mesh import Axis, axis_group, psum_backward, psum_forward


def gelu(x):
    """flax's ``nn.gelu`` (the tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def copy_to_tp(x: torch.Tensor, axis: Axis = "tp") -> torch.Tensor:
    """Megatron's f over ``axis``: identity forward, all-reduce backward."""
    return psum_backward(x, axis_group(axis))


def reduce_from_tp(x: torch.Tensor, axis: Axis = "tp") -> torch.Tensor:
    """Megatron's g over ``axis``: all-reduce forward, identity
    backward."""
    return psum_forward(x, axis_group(axis))


#: path suffix -> spec builder (the axis substituted in), torch layouts
TP_MLP_RULES: Dict[str, Callable] = {
    "up/kernel": lambda tp: (tp, None),       # column parallel: [out, in]
    "up/bias": lambda tp: (tp,),              # follows the output shard
    "down/kernel": lambda tp: (None, tp),     # row parallel (g after it)
    "down/bias": lambda tp: (),               # replicated, after g
}

#: the attention projections (``models/bert.py`` ``SelfAttention``'s
#: ``DenseGeneral``s, weights ``[prod(out), prod(in)]``): query, key and
#: value are column parallel over heads (their ``[heads · head_dim, d]``
#: rows, head-major), the output projection ``[d, heads · head_dim]`` row
#: parallel
TP_ATTENTION_RULES: Dict[str, Callable] = {
    "query/kernel": lambda tp: (tp, None),
    "key/kernel": lambda tp: (tp, None),
    "value/kernel": lambda tp: (tp, None),
    "query/bias": lambda tp: (tp,),
    "key/bias": lambda tp: (tp,),
    "value/bias": lambda tp: (tp,),
    "out/kernel": lambda tp: (None, tp),
    "out/bias": lambda tp: (),
}


def shard_leaf(t: torch.Tensor, spec: Tuple, rank: int,
               size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s block of ``t`` along every dim that
    ``spec`` shards (a copy, contiguous)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        if t.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} is not "
                             f"divisible by {size}")
        block = t.shape[dim] // size
        t = t.narrow(dim, rank * block, block)
    return t.detach().clone(memory_format=torch.contiguous_format)


def spec_for(name: str, rules: Mapping[str, Callable], axis,
             default: Optional[Tuple] = None) -> Tuple:
    """The spec of the parameter ``name``: its first matching rule's, else
    ``default`` (replicated if None)."""
    for suffix, builder in rules.items():
        if name.endswith(suffix):
            return builder(axis)
    return default if default is not None else ()


def shard_tp_params(params: Mapping[str, torch.Tensor], *,
                    rules: Mapping[str, Callable], axis: Axis = "tp",
                    default: Optional[Tuple] = None
                    ) -> Dict[str, torch.Tensor]:
    """Each parameter sliced to this rank's shard along ``axis`` by its
    rule (leaves with no rule get ``default``, replicated if None): the
    reference's ``device_put`` with a ``NamedSharding``, per rank.
    ``params`` maps canonical names to full tensors; returns new tensors
    under the same names."""
    group = axis_group(axis)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    return {name: shard_leaf(t, spec_for(name, rules, axis, default), rank,
                             size)
            for name, t in params.items()}


def _gather(x, dim, group):
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _block(x, dim, group):
    return shard_leaf(x, (None,) * dim + (True,), dist.get_rank(group),
                      dist.get_world_size(group))


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward this rank's block of the
    gradient (the consumer of a replicated value computes alike on every
    rank, as Megatron's gather)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.dim, ctx.group), None, None


class _Slice(torch.autograd.Function):
    """This rank's block along ``dim`` forward; backward all-gathers the
    gradient (Megatron's scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


def tp_constraint(x: torch.Tensor, spec: Tuple, *, axis: Axis = "tp",
                  current: Tuple = ()) -> torch.Tensor:
    """Bring an activation from the layout ``current`` to the layout
    ``spec`` along ``axis`` (the reference's ``with_sharding_constraint``
    at a TP boundary): a dim sharded in ``current`` and not in ``spec`` is
    all-gathered, a dim sharded in ``spec`` and not in ``current`` sliced
    to this rank's block.  Differentiable."""
    group = axis_group(axis)
    if dist.get_world_size(group) == 1:
        return x
    for dim in range(x.dim()):
        was = dim < len(current) and current[dim] is not None
        want = dim < len(spec) and spec[dim] is not None
        if was and not want:
            x = _Gather.apply(x, dim, group)
        elif want and not was:
            x = _Slice.apply(x, dim, group)
    return x


class ParallelMLP(nn.Module):
    """The reference's two-layer MLP, ``down(gelu(up(x)))``, its
    parameter names those of :data:`TP_MLP_RULES`.  With ``axis`` it is
    this rank's tensor-parallel shard: the module is built whole (the
    same generator gives every rank the same weights), then ``up`` keeps
    its rows and ``down`` its columns of this rank along ``axis``, and
    the forward runs f before ``up`` and g after ``down``'s product, then
    adds ``down``'s bias once.  ``axis`` resolves when the module is
    built (``parallel/mesh.py``)."""

    def __init__(self, in_features: int, hidden: int, out: int, *,
                 dtype: torch.dtype = torch.bfloat16,
                 activation: Callable = gelu, axis: Axis = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.up = Dense(in_features, hidden, dtype=dtype, generator=generator)
        self.down = Dense(hidden, out, dtype=dtype, generator=generator)
        self.group = None if axis is None else axis_group(axis)
        if self.group is not None:
            shards = shard_tp_params(canonical_params(self),
                                     rules=TP_MLP_RULES, axis=self.group)
            for name, t in canonical_params(self).items():
                t.data = shards[name]

    def forward(self, x):
        if self.group is None:
            return self.down(self.activation(self.up(x)))
        x = psum_backward(x, self.group)
        h = self.activation(self.up(x))
        dt = self.down.dtype or h.dtype
        y = psum_forward(F.linear(h.to(dt), self.down.weight.to(dt)),
                         self.group)
        return y + self.down.bias.to(dt)

