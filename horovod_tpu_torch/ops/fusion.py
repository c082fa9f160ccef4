"""Tensor fusion: many small gradients reduced as few large collectives.

The port of ``horovod_tpu/ops/fusion.py``, back on the reference
Horovod's own GPU design: each bucket of same-dtype tensors is packed
into one flat contiguous buffer, reduced with ONE ``all_reduce`` over
NCCL, and handed back as views of the reduced buffer.  Each bucket's
call runs inside a range named after its tensors (torch.profiler's and,
on CUDA, NVTX's), which is what the fork's per-tensor NCCL tagging shows
in a profiler.  With a
quantizer, the scales of every tensor of the call come from one MAX
all-reduce, and error feedback carries each rank's residual.

:class:`FusionPlan` is pure logic and gives the reference's bucket
lists exactly for the same leaves, threshold or explicit plan.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import metrics as _metrics
from ..core import Average
from ..utils import env as env_util
from ..utils.tree import tree_flatten, tree_leaf_names, tree_unflatten
from .collectives import ProcessSet, group_of, reduce_op
from .compression import (
    Compression, _compressible, _reduce_max_, average_, check_wire,
    compress_with, inner, is_scaled, local_max_abs,
)
from .sparse import allreduce_indexed_slices, is_indexed_slices, to_dense

__all__ = ["FusionPlan", "tree_leaf_names", "fused_allreduce",
           "allreduce_pytree"]

#: longest NVTX range name a bucket gets (names past it are elided)
_NVTX_NAME_CHARS = 512


class FusionPlan:
    """A static bucketing of a fixed list of leaves (anything with a
    ``dtype`` and a ``numel()``, meta tensors included).

    * **threshold** mode: greedy same-dtype packing under
      ``threshold_bytes`` (default ``HVD_FUSION_THRESHOLD``, 64 MiB);
    * **explicit** mode (``explicit_buckets``): the caller names which
      leaves fuse together, in dispatch order; mixed-dtype buckets are
      split by dtype, and leaves no bucket claims are appended as
      singletons, so a plan never drops a gradient.

    ``buckets`` is the dispatch order.
    """

    def __init__(self, leaves: Sequence[Any],
                 threshold_bytes: Optional[int] = None,
                 explicit_buckets: Optional[Sequence[Sequence[int]]] = None,
                 bucket_compression: Optional[Sequence[Optional[str]]] = None):
        if threshold_bytes is None:
            threshold_bytes = env_util.fusion_threshold_bytes()
        self.threshold_bytes = max(int(threshold_bytes), 1)
        self.explicit = explicit_buckets is not None
        self.buckets: List[List[int]] = []
        #: per bucket: a compression registry name, or None for the
        #: call's own compression
        self.bucket_compression: List[Optional[str]] = []
        if explicit_buckets is not None:
            self._build_explicit(leaves, explicit_buckets,
                                 bucket_compression)
        else:
            self._build_threshold(leaves)

    def _build_threshold(self, leaves: Sequence[Any]) -> None:
        current: dict = {}  # dtype -> (bucket index, bytes so far)
        for i, leaf in enumerate(leaves):
            nbytes = leaf.numel() * leaf.element_size()
            slot = current.get(leaf.dtype)
            if slot is not None and slot[1] + nbytes <= self.threshold_bytes:
                self.buckets[slot[0]].append(i)
                current[leaf.dtype] = (slot[0], slot[1] + nbytes)
            else:
                self.buckets.append([i])
                current[leaf.dtype] = (len(self.buckets) - 1, nbytes)
        self.bucket_compression = [None] * len(self.buckets)

    def _build_explicit(self, leaves, explicit, compression) -> None:
        n = len(leaves)
        seen: set = set()
        for bi, bucket in enumerate(explicit):
            comp = compression[bi] if compression is not None \
                and bi < len(compression) else None
            by_dtype: dict = {}  # dtype -> indices, order kept
            for i in bucket:
                i = int(i)
                if not 0 <= i < n:
                    raise ValueError(
                        f"fusion plan references leaf {i} but only {n} "
                        "leaves exist")
                if i in seen:
                    raise ValueError(
                        f"fusion plan assigns leaf {i} to two buckets")
                seen.add(i)
                by_dtype.setdefault(leaves[i].dtype, []).append(i)
            for b in by_dtype.values():
                self.buckets.append(b)
                self.bucket_compression.append(comp)
        for i in range(n):
            if i not in seen:
                self.buckets.append([i])
                self.bucket_compression.append(None)

    @classmethod
    def from_named_buckets(cls, leaves: Sequence[Any], names: Sequence[str],
                           named_buckets: Sequence[Sequence[str]],
                           bucket_compression:
                           Optional[Sequence[Optional[str]]] = None
                           ) -> "FusionPlan":
        """Explicit plan from tensor NAMES matched against the leaf names:
        exact match first, then path suffix either way.  Unmatched plan
        names are ignored; unmatched leaves become appended singletons."""
        index = {str(nm): i for i, nm in enumerate(names)}

        def match(name: str) -> Optional[int]:
            if name in index:
                return index[name]
            for nm, i in index.items():
                if nm.endswith("/" + name) or name.endswith("/" + nm):
                    return i
            return None

        used: set = set()
        explicit: List[List[int]] = []
        comps: List[Optional[str]] = []
        for bi, bucket in enumerate(named_buckets):
            idxs = []
            for name in bucket:
                i = match(str(name))
                if i is not None and i not in used:
                    used.add(i)
                    idxs.append(i)
            if idxs:
                explicit.append(idxs)
                comps.append(bucket_compression[bi]
                             if bucket_compression is not None
                             and bi < len(bucket_compression) else None)
        return cls(leaves, explicit_buckets=explicit,
                   bucket_compression=comps)

    def num_buckets(self) -> int:
        return len(self.buckets)


def dispatch_group_label(process_set: Optional[ProcessSet] = None) -> str:
    """The communication-group label a dispatch reduces over — ``world``
    for the whole job, ``process_set:<ranks>`` for a subset (the
    reference's protocol string, ``horovod_tpu/ops/fusion.py``)."""
    if process_set is None:
        return "world"
    return "process_set:" + ",".join(str(r) for r in process_set.ranks)


def _bucket_range(flat: torch.Tensor, names: Sequence[str]):
    """The bucket's range, named ``allreduce:<its tensors>``: a
    torch.profiler range (what an ``HVD_PROFILE_XLA`` capture shows)
    and, on CUDA, an NVTX range."""
    label = "allreduce:" + ",".join(names)
    if len(label) > _NVTX_NAME_CHARS:
        label = label[:_NVTX_NAME_CHARS - 3] + "..."
    stack = contextlib.ExitStack()
    stack.enter_context(torch.profiler.record_function(label))
    if flat.device.type == "cuda":
        stack.enter_context(torch.cuda.nvtx.range(label))
    return stack


def _global_maxima(xs: List[torch.Tensor], comps, group, group_size: int):
    """``{i: global max |xs[i]|}`` for every tensor a scaled quantizer
    compresses.  The reference takes one ``pmax`` per tensor; here the
    local maxima are stacked and reduced in ONE MAX all-reduce.  A max is
    taken elementwise, so each tensor's factor is bit-identical to what
    its own all-reduce would give."""
    scaled = [i for i, (x, c) in enumerate(zip(xs, comps))
              if is_scaled(c) and _compressible(x)
              and inner(c).keeps_levels(group_size)]
    if not scaled:
        return {}
    maxima = _reduce_max_(local_max_abs([xs[i] for i in scaled]), group)
    return {i: maxima[j] for j, i in enumerate(scaled)}


def fused_allreduce(tensors: List[torch.Tensor], *, op: str = Average,
                    compression=Compression.none,
                    process_set: Optional[ProcessSet] = None,
                    threshold_bytes: Optional[int] = None,
                    plan: Optional[FusionPlan] = None,
                    names: Optional[Sequence[str]] = None,
                    residuals: Optional[List[torch.Tensor]] = None):
    """Allreduce a list of tensors with static bucketing; returns the
    list in the input order.  Inputs are not modified: each bucket is
    packed into a fresh flat buffer (``torch.cat``), reduced in place
    there, and the outputs are views of it.  ``names`` label the NVTX
    ranges.  Over a ``process_set``, the set's ranks reduce among
    themselves and a rank outside it gets copies of its inputs.

    Each tensor is compressed with ``compress_for(t, group_size)``, the
    group being the process set's where one is given, so a quantizer
    leaves the headroom of the group's sum; a plan's per-bucket
    compression names override ``compression`` for their members.

    ``residuals`` (aligned with ``tensors``) turns on error feedback:
    each float tensor reduces ``x = t + r``, and the call returns
    ``(outputs, new_residuals)`` with ``r' = x - decompress(compress(x))``
    (what the wire dropped, carried to the next step)."""
    dist_op = reduce_op(op)
    if residuals is not None and len(residuals) != len(tensors):
        raise ValueError(
            f"error-feedback residual list has {len(residuals)} entries "
            f"for {len(tensors)} tensors")
    member, group, group_size = group_of(process_set)
    # a subset's reductions ride the group-labelled traced inventory (the
    # whole job is the unlabelled default, as in the reference)
    group_label = dispatch_group_label(process_set)
    if group_label != "world":
        for _ in tensors:
            _metrics.record_traced_group("allreduce", group_label)
    if not member:
        out = [t.clone() for t in tensors]
        return (out, list(residuals)) if residuals is not None else out
    names = list(names) if names is not None \
        else [str(i) for i in range(len(tensors))]
    comps = [compression] * len(tensors)
    if plan is not None:
        for bi, bucket in enumerate(plan.buckets):
            name = plan.bucket_compression[bi] \
                if bi < len(plan.bucket_compression) else None
            if name:
                comp = Compression.lookup(name)
                for i in bucket:
                    comps[i] = comp

    ef = [residuals is not None and _compressible(t) for t in tensors]
    xs = [t + residuals[i].to(t.dtype) if ef[i] else t
          for i, t in enumerate(tensors)]
    maxima = _global_maxima(xs, comps, group, group_size)
    compressed, ctxs = [], []
    new_res = list(residuals) if residuals is not None else None
    for i, (x, comp) in enumerate(zip(xs, comps)):
        c, ctx = compress_with(comp, x, group_size, max_abs=maxima.get(i))
        check_wire(c.dtype, c.device)
        if ef[i]:
            # this rank's dequantized contribution to the sum; what the
            # wire dropped goes to the next step
            new_res[i] = (x - comp.decompress(c, ctx)).to(
                residuals[i].dtype)
        compressed.append(c)
        ctxs.append(ctx)

    if plan is None:
        plan = FusionPlan(compressed, threshold_bytes)
    elif sorted(i for b in plan.buckets for i in b) \
            != list(range(len(compressed))):
        # a stale plan (the model gained or lost a parameter since it was
        # built) must fail loudly, not return None for a gradient
        raise ValueError(
            f"fusion plan covers {sum(len(b) for b in plan.buckets)} "
            f"tensors but the call passed {len(compressed)}")
    out: List[Any] = [None] * len(tensors)
    for bucket in plan.buckets:
        flat = torch.cat([compressed[i].reshape(-1) for i in bucket])
        with _bucket_range(flat, [names[i] for i in bucket]):
            dist.all_reduce(flat, op=dist_op, group=group)
        if op == Average:
            flat = average_(flat, group_size)
        offset = 0
        for i in bucket:
            n = compressed[i].numel()
            piece = flat[offset:offset + n].view(compressed[i].shape)
            out[i] = comps[i].decompress(piece, ctxs[i])
            offset += n
    if new_res is not None:
        return out, new_res
    return out


def allreduce_pytree(tree, *, op: str = Average,
                     compression=Compression.none,
                     process_set: Optional[ProcessSet] = None,
                     threshold_bytes: Optional[int] = None,
                     sparse_as_dense: bool = False,
                     named_buckets: Optional[Sequence[Sequence[str]]] = None,
                     bucket_compression:
                     Optional[Sequence[Optional[str]]] = None,
                     residual=None):
    """Fused allreduce over every tensor of a (nested) dict of tensors,
    leaves in the reference's order.  ``named_buckets`` applies an
    explicit fusion plan by leaf name (see
    :meth:`FusionPlan.from_named_buckets`).

    :class:`~horovod_tpu_torch.ops.sparse.IndexedSlices` leaves take the
    sparse allgather path unless ``sparse_as_dense`` densifies them
    first.  ``residual`` (a tree shaped like ``tree``) turns on error
    feedback: the call returns ``(reduced, new_residual)``; a sparse
    leaf's residual is left untouched (the allgather is exact)."""
    leaves, treedef = tree_flatten(tree)
    names = tree_leaf_names(tree)
    res_leaves = None
    if residual is not None:
        res_leaves = tree_flatten(residual)[0]
        if len(res_leaves) != len(leaves):
            raise ValueError(
                "error-feedback residual tree does not match the gradient "
                f"tree ({len(res_leaves)} vs {len(leaves)} leaves) — "
                "initialize it with ErrorFeedback.init_state")
    out: List[Any] = [None] * len(leaves)
    res_out = list(res_leaves) if res_leaves is not None else []
    dense_idx = []
    for i, leaf in enumerate(leaves):
        if is_indexed_slices(leaf):
            if sparse_as_dense:
                leaves[i] = to_dense(leaf)
            else:
                out[i] = allreduce_indexed_slices(leaf, op=op,
                                                  process_set=process_set)
                continue
        dense_idx.append(i)
    dense = [leaves[i] for i in dense_idx]
    dense_names = [names[i] for i in dense_idx]
    plan = FusionPlan.from_named_buckets(
        dense, dense_names, named_buckets,
        bucket_compression=bucket_compression) if named_buckets else None
    reduced = fused_allreduce(
        dense, op=op, compression=compression, process_set=process_set,
        threshold_bytes=threshold_bytes, plan=plan, names=dense_names,
        residuals=[res_leaves[i] for i in dense_idx]
        if res_leaves is not None else None)
    if res_leaves is not None:
        reduced, new_res = reduced
        for i, r in zip(dense_idx, new_res):
            res_out[i] = r
    for i, r in zip(dense_idx, reduced):
        out[i] = r
    result = tree_unflatten(treedef, out)
    if residual is not None:
        return result, tree_unflatten(treedef, res_out)
    return result
