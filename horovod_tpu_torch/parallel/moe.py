"""Expert parallelism, a mixture-of-experts layer with all-to-all token
dispatch: the port of ``horovod_tpu/parallel/moe.py``.

The reference's GShard form: static capacity-bounded dispatch tensors
(no data-dependent shapes), einsum dispatch and combine, and one
all-to-all each way over the ``ep`` axis (``parallel/mesh.all_to_all``,
its own backward) between the ranks that hold the tokens and the ranks
that hold the experts.  Each rank holds ``n_local`` tokens and
``experts_per_rank`` experts, ``E = ep · experts_per_rank``; top-1
routing with per-expert capacity C drops the tokens past it.

Not ported: the reference's schedule-checker remarks.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.distributed as dist

from .mesh import Axis, all_to_all, axis_group


def top1_dispatch(gates: torch.Tensor, capacity: int):
    """``(dispatch, combine)``, each ``[n, E, C]`` in ``gates``' dtype,
    from router probabilities ``gates [n, E]``: token t goes to slot
    ``position(t)`` of its argmax expert (the first on a tie) unless that
    expert is past ``capacity``; ``combine`` carries the gate.  Positions
    are counted in int32: a low-precision cumsum (bf16 gates) saturates
    at 256 tokens and collides slots."""
    e = gates.shape[1]
    expert = gates.argmax(-1)                                  # [n]
    onehot_i = torch.nn.functional.one_hot(expert, e).to(torch.int32)
    pos = ((torch.cumsum(onehot_i, 0, dtype=torch.int32) - onehot_i)
           * onehot_i).sum(-1, dtype=torch.int32)              # [n]
    keep = pos < capacity
    onehot = onehot_i.to(gates.dtype)
    gate = (gates * onehot).amax(-1) * keep                    # [n]
    # jax.nn.one_hot: a position past the capacity is all zeros
    pos_oh = (pos[:, None] == torch.arange(
        capacity, device=gates.device)).to(gates.dtype)        # [n, C]
    dispatch = onehot[:, :, None] * pos_oh[:, None, :] * keep[:, None, None]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine


def moe_apply(expert_fn: Callable, expert_params: Mapping[str, torch.Tensor],
              x: torch.Tensor, router_kernel: torch.Tensor, *,
              capacity: int, axis: Axis = "ep") -> torch.Tensor:
    """One expert-parallel MoE layer over ``axis``.

    ``expert_fn(params_of_one_expert, tokens [m, d]) -> [m, d]``;
    ``expert_params``: this rank's experts stacked ``[experts_per_rank,
    ...]``; ``x``: this rank's tokens ``[n_local, d]``;
    ``router_kernel``: ``[d, E]`` routing weights, the same on every
    rank; ``capacity``: per expert and per source rank.  Returns ``[n_local,
    d]``, each token's expert output weighted by its gate (a dropped
    token gives zero)."""
    group = axis_group(axis)
    ep = dist.get_world_size(group)
    d = x.shape[1]
    e = router_kernel.shape[-1]
    if e % ep:
        raise ValueError(f"experts {e} not divisible by ep={ep}")
    per_rank = e // ep
    gates = torch.softmax(x.float() @ router_kernel.float(), -1).to(x.dtype)
    dispatch, combine = top1_dispatch(gates, capacity)
    expert_in = torch.einsum("nd,nec->ecd", x, dispatch)       # [E, C, d]
    # after the exchange this rank holds, for its experts, every source
    # rank's buffers: [ep(src), per_rank, C, d]
    expert_in = all_to_all(expert_in.reshape(ep, per_rank, capacity, d),
                           group)
    flat = expert_in.movedim(1, 0).reshape(per_rank, ep * capacity, d)
    out = torch.stack([
        expert_fn({k: v[i] for k, v in expert_params.items()}, flat[i])
        for i in range(per_rank)])                             # [per_rank, ep·C, d]
    out = out.reshape(per_rank, ep, capacity, d).movedim(0, 1)
    out = all_to_all(out, group).reshape(e, capacity, d)       # route back
    return torch.einsum("ecd,nec->nd", out, combine.to(out.dtype))
