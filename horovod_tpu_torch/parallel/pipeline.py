"""Pipeline parallelism, a GPipe-style microbatch pipeline over a mesh
axis: the port of ``horovod_tpu/parallel/pipeline.py``.

The reference's "circulating buffer" form: every stage shares one
activation shape; with S stages and M microbatches the loop runs ``T =
M + S - 1`` ticks.  Each tick every rank applies its stage to its
resident activation and the results rotate one stage on
(``parallel/mesh.ppermute``, whose backward rotates the gradients back);
rank 0 takes microbatch ``t`` at tick ``t`` in place of what it
received, rank ``S - 1`` banks its output for microbatch ``t - (S -
1)``, and a final sum over the axis replicates the banked outputs (only
the last rank's are nonzero).

Every rank runs every tick's rotation and its backward, or a neighbour
waits forever: rank 0's input is chosen with ``torch.where``, not an
``if``, so the state it received stays in its autograd graph (and its
rotation's backward runs), and the last rank banks with ``torch.where``
too, so every rank's graph has one shape and the backward runs the
rotations in one order everywhere.  The final sum's backward is the
identity (``psum_forward``): the reference's ``pbroadcast`` under
``check_vma=True``.  A plain all-reduce backward would scale every
gradient by S, the mis-scaling the reference warns of under
``check_vma=False``.

Not ported: the reference's replication-checker probe and its warning
(the port's final sum has the right backward by construction), and its
schedule-checker remarks.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from .mesh import Axis, axis_group, ppermute, psum_forward


def pipeline_apply(stage_fn: Callable, stage_params, x_mbs: torch.Tensor,
                   *, axis: Axis = "pp") -> torch.Tensor:
    """Run the microbatches ``x_mbs`` ``[M, microbatch, ...]`` (the same
    on every rank of the axis; rank 0 reads them) through the S-stage
    pipeline of ``stage_fn(stage_params, x) -> y`` (``y`` shaped like
    ``x``), ``stage_params`` being this rank's stage's.  Returns the
    outputs ``[M, microbatch, ...]``, the same on every rank of the
    axis."""
    group = axis_group(axis)
    s, idx = dist.get_world_size(group), dist.get_rank(group)
    m = x_mbs.shape[0]
    first = torch.full((), idx == 0, device=x_mbs.device)
    state = torch.zeros_like(x_mbs[0])
    banked = [torch.zeros_like(x_mbs[0]) for _ in range(m)]
    for t in range(m + s - 1):
        # past the last microbatch rank 0 feeds the last again: its exit
        # lands outside the banked window, as the reference's clip
        inp = torch.where(first, x_mbs[min(t, m - 1)], state)
        out = stage_fn(stage_params, inp)
        pos = t - (s - 1)
        if pos >= 0:
            bank = torch.full((), idx == s - 1, device=x_mbs.device)
            banked[pos] = torch.where(bank, out, banked[pos])
        if t < m + s - 2:   # the last tick's rotation is never read
            (state,) = ppermute((out,), group)
    return psum_forward(torch.stack(banked), group)


def stack_stage_params(per_stage_params: Sequence[Mapping[str, torch.Tensor]]
                       ) -> dict:
    """S per-stage parameter dicts stacked on a new leading axis (index it
    with this rank's stage: :func:`stage_params`)."""
    return {k: torch.stack([p[k] for p in per_stage_params])
            for k in per_stage_params[0]}


def stage_params(stacked: Mapping[str, torch.Tensor],
                 axis: Axis = "pp") -> dict:
    """This rank's stage of :func:`stack_stage_params`' result: index
    this rank's position along ``axis`` on the leading axis (a view, so its gradients land
    in the stacked tensors)."""
    idx = dist.get_rank(axis_group(axis))
    return {k: v[idx] for k, v in stacked.items()}
