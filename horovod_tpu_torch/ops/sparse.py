"""Sparse (IndexedSlices) gradients, reduced by allgather: the port of
``horovod_tpu/ops/sparse.py``.

* :class:`IndexedSlices` — rows of a dense tensor: ``dense[indices[i]]
  += values[i]``; a leaf of the port's trees.
* :func:`allreduce_indexed_slices` — an allgather of the values and of
  the indices over the group; Average divides the values by its size.
  Duplicate indices are legal: consumers scatter-add.
* :func:`to_dense` — the scatter-add into the dense shape.
* :func:`embedding_grad_as_slices` — the gradient of a table used only
  through ``table[ids]``, taken with respect to the gathered rows.

``fusion.allreduce_pytree`` routes IndexedSlices leaves here.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from .. import core
from ..core import Average, Sum
from ..utils.tree import tree_flatten, tree_unflatten


class IndexedSlices:
    """``values``: ``[k, *dense_shape[1:]]``; ``indices``: ``[k]``
    integers; ``dense_shape``: a tuple."""

    def __init__(self, values: torch.Tensor, indices: torch.Tensor,
                 dense_shape: Sequence[int]):
        self.values = values
        self.indices = indices
        self.dense_shape = tuple(int(d) for d in dense_shape)

    def __repr__(self):
        return (f"IndexedSlices(values={self.values!r}, "
                f"indices={self.indices!r}, dense_shape={self.dense_shape})")


def is_indexed_slices(x: Any) -> bool:
    return isinstance(x, IndexedSlices)


def to_dense(s: IndexedSlices) -> torch.Tensor:
    """Scatter-add the slices into their dense shape."""
    dense = s.values.new_zeros(s.dense_shape)
    return dense.index_add_(0, s.indices.long(), s.values)


def allreduce_indexed_slices(s: IndexedSlices, *, op: str = Average,
                             process_set=None) -> IndexedSlices:
    """Every rank's rows concatenated in rank order (values and indices
    allgathered); Average divides the values by the group's size."""
    from .collectives import allgather

    if op not in (Average, Sum):
        raise ValueError(f"unsupported op for sparse allreduce: {op}")
    size = process_set.size() if process_set is not None else core.size()
    values = allgather(s.values, process_set=process_set)
    indices = allgather(s.indices, process_set=process_set)
    if op == Average:
        values = values / size
    return IndexedSlices(values, indices, s.dense_shape)


def embedding_grad_as_slices(loss_of_rows, table: torch.Tensor,
                             ids: torch.Tensor, *args, **kwargs):
    """``(loss, IndexedSlices)``: the gradient of ``loss_of_rows(table[ids],
    *args)`` with respect to the gathered rows, one row per lookup
    (duplicate ids stay duplicated).  Exact when the table enters the
    loss only through this lookup."""
    rows = table.detach()[ids].requires_grad_(True)
    loss = loss_of_rows(rows, *args, **kwargs)
    (g_rows,) = torch.autograd.grad(loss, [rows])
    flat_ids = ids.reshape(-1)
    flat_g = g_rows.reshape((flat_ids.shape[0], *table.shape[1:]))
    return loss.detach(), IndexedSlices(flat_g, flat_ids, table.shape)


def densify_tree(tree):
    """Every IndexedSlices leaf as its dense tensor."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [to_dense(x) if is_indexed_slices(x)
                                    else x for x in leaves])
