"""Tensor fusion: many small gradients reduced as few large collectives.

The port of ``horovod_tpu/ops/fusion.py``, back on the reference
Horovod's own GPU design: each bucket of same-dtype tensors is packed
into one flat contiguous buffer, reduced with ONE ``all_reduce`` over
NCCL, and handed back as views of the reduced buffer.  Each bucket's call
runs inside an NVTX range named after its tensors, which is what the
fork's per-tensor NCCL tagging shows in a profiler.

:class:`FusionPlan` is pure logic and gives the reference's bucket
lists exactly for the same leaves, threshold or explicit plan.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import core
from ..core import Average
from ..utils import env as env_util
from ..utils.tree import tree_flatten, tree_leaf_names, tree_unflatten
from .collectives import reduce_op
from .compression import Compression

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


def _nvtx_range(flat: torch.Tensor, names: Sequence[str]):
    """The bucket's NVTX range on CUDA; nothing on the CPU, where torch
    has no NVTX."""
    if flat.device.type != "cuda":
        return contextlib.nullcontext()
    label = "allreduce:" + ",".join(names)
    if len(label) > _NVTX_NAME_CHARS:
        label = label[:_NVTX_NAME_CHARS - 3] + "..."
    return torch.cuda.nvtx.range(label)


def fused_allreduce(tensors: List[torch.Tensor], *, op: str = Average,
                    compression=Compression.none,
                    threshold_bytes: Optional[int] = None,
                    plan: Optional[FusionPlan] = None,
                    names: Optional[Sequence[str]] = None
                    ) -> List[torch.Tensor]:
    """Allreduce a list of tensors with static bucketing; returns the
    list in the input order.  Inputs are not modified: each bucket is
    packed into a fresh flat buffer (``torch.cat``), reduced in place
    there, and the outputs are views of it.  ``names`` label the NVTX
    ranges."""
    dist_op = reduce_op(op)
    group_size = core.size()
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
    compressed, ctxs = [], []
    for t, comp in zip(tensors, comps):
        c, ctx = comp.compress(t)
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
        with _nvtx_range(flat, [names[i] for i in bucket]):
            dist.all_reduce(flat, op=dist_op)
        if op == Average:
            flat.div_(group_size)
        offset = 0
        for i in bucket:
            n = compressed[i].numel()
            piece = flat[offset:offset + n].view(compressed[i].shape)
            out[i] = comps[i].decompress(piece, ctxs[i])
            offset += n
    return out


def allreduce_pytree(tree, *, op: str = Average,
                     compression=Compression.none,
                     threshold_bytes: Optional[int] = None,
                     named_buckets: Optional[Sequence[Sequence[str]]] = None,
                     bucket_compression:
                     Optional[Sequence[Optional[str]]] = None):
    """Fused allreduce over every tensor of a (nested) dict of tensors,
    leaves in the reference's order.  ``named_buckets`` applies an
    explicit fusion plan by leaf name (see
    :meth:`FusionPlan.from_named_buckets`)."""
    leaves, treedef = tree_flatten(tree)
    names = tree_leaf_names(tree)
    plan = FusionPlan.from_named_buckets(
        leaves, names, named_buckets,
        bucket_compression=bucket_compression) if named_buckets else None
    reduced = fused_allreduce(leaves, op=op, compression=compression,
                              threshold_bytes=threshold_bytes, plan=plan,
                              names=names)
    return tree_unflatten(treedef, reduced)
