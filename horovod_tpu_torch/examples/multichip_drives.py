"""The model-parallel drives of the reference's ``dryrun_multichip``
(``__graft_entry__.py``): one training step on each composition of the
parallel layers, with the reference's shapes, seeds and learning rate,
returning the loss the reference returns.

* :func:`dp_sp` — ring attention over ``sp`` of a ``(dp, 2)`` mesh,
  gradients summed over both axes; the loss after the update
  (``_dryrun_dp_sp``);
* :func:`dp_tp` — :class:`ParallelMLP` over ``tp`` of a ``(dp, 2)``
  mesh, the batch over ``dp`` (``_dryrun_dp_tp``);
* :func:`dp_pp` — a 4-stage (2 when the world is not a multiple of 4)
  microbatch pipeline over ``pp`` of a ``(dp, pp)`` mesh
  (``_dryrun_dp_pp``);
* :func:`ep` — a top-1 MoE layer, one expert a rank over ``ep``
  (``_dryrun_ep``);
* :func:`dp_tp_pp` — a ``(dp, 2, 2)`` mesh whose every pipeline stage
  is a Megatron MLP over ``tp`` (``_dryrun_dp_tp_pp``).

Every rank of the world calls the drive (each builds its mesh, which is
collective); the data comes from the reference's numpy seeds, so the
loss equals the reference's at the same world size.  The one exception
is :func:`dp_tp`'s weights, which the reference draws from flax's
``PRNGKey(0)``: pass them (flax layout, ``params``) to compare, or the
MLP draws its own from a torch generator seeded with 0.  Each runs on
this rank's device (``core.device()``).

Run one (every rank of a launched job):
    python -c "import horovod_tpu_torch as h; h.init(device='cpu'); \\
        from horovod_tpu_torch.examples import multichip_drives as d; \\
        print(d.dp_sp())"
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import core
from ..convert import canonical_params, parallel_mlp_params_from_flax
from ..parallel.mesh import axis_group, make_mesh, use_mesh
from ..parallel.moe import moe_apply
from ..parallel.pipeline import (
    pipeline_apply, stack_stage_params, stage_params,
)
from ..parallel.ring_attention import ring_attention
from ..parallel.tensor_parallel import (
    ParallelMLP, copy_to_tp, reduce_from_tp,
)

#: the reference's SGD step size in every drive
LR = 0.1


def _t(a: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.tensor(a, device=core.device(), requires_grad=grad)


def _all_reduce(x: torch.Tensor, axis=None, average: bool = False
                ) -> torch.Tensor:
    group = axis_group(axis)
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group) if average else x


def _sgd(params: Dict[str, torch.Tensor], grads) -> Dict[str, torch.Tensor]:
    return {k: (p - LR * g).detach() for (k, p), g in zip(params.items(),
                                                          grads)}


def dp_sp() -> float:
    """``_dryrun_dp_sp``: embedding, causal ring attention over ``sp``
    and a projection, the log-likelihood summed over this rank's block
    over the global token count; one SGD step on gradients summed over
    the world; returns the loss after the step, summed over the world."""
    n = core.size()
    dp = n // 2
    b, s, h, d, vocab = dp * 2, 32, 4, 8, 64
    rng = np.random.default_rng(1)
    params = {
        "emb": rng.normal(scale=0.1, size=(vocab, h * d)).astype(np.float32),
        "proj": rng.normal(scale=0.1, size=(h * d, vocab)).astype(np.float32),
    }
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    mesh = make_mesh((dp, 2), ("dp", "sp"))
    row, col = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    bl, sl = b // dp, s // 2
    block = (slice(row * bl, (row + 1) * bl), slice(col * sl, (col + 1) * sl))
    my_ids = _t(ids[block]).long()
    my_labels = _t(labels[block]).long()

    def local_loss(p):
        x = p["emb"][my_ids].reshape(bl, sl, h, d)
        out = ring_attention(x, x, x, causal=True, axis="sp")
        logits = out.reshape(bl, sl, h * d) @ p["proj"]
        logp = torch.log_softmax(logits.float(), -1)
        ll = torch.gather(logp, -1, my_labels[..., None])
        return -ll.sum() / (b * s)

    with use_mesh(mesh):
        p = {k: _t(v, grad=True) for k, v in params.items()}
        grads = torch.autograd.grad(local_loss(p), list(p.values()))
        # the reference's psum over ("dp", "sp"): the whole mesh
        new = _sgd(p, [_all_reduce(g, dist.group.WORLD) for g in grads])
        with torch.no_grad():
            loss = _all_reduce(local_loss(new), dist.group.WORLD)
    return float(loss.item())


def dp_tp(params: Optional[Mapping] = None) -> float:
    """``_dryrun_dp_tp``: a ``ParallelMLP(16 → 64 → 8)`` in float32, its
    ``up`` column- and ``down`` row-parallel over ``tp``, two rows of the
    batch a ``dp`` row; the mean squared error over the whole batch and
    one SGD step.  ``params``: the reference's initial flax parameters
    (nested or flat); returns the loss before the step."""
    n = core.size()
    dp = n // 2
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2 * dp, 16)).astype(np.float32)
    y = rng.normal(size=(2 * dp, 8)).astype(np.float32)
    mesh = make_mesh((dp, 2), ("dp", "tp"))
    row = mesh.get_local_rank("dp")
    with use_mesh(mesh):
        with torch.device(core.device()):
            model = ParallelMLP(16, 64, 8, dtype=torch.float32, axis="tp",
                                generator=torch.Generator(
                                    device=core.device()).manual_seed(0))
        if params is not None:
            group = axis_group("tp")
            shards = parallel_mlp_params_from_flax(
                params, rank=dist.get_rank(group),
                size=dist.get_world_size(group))
            with torch.no_grad():
                for name, t in canonical_params(model).items():
                    t.copy_(shards[name])
        rows = slice(2 * row, 2 * row + 2)
        loss = torch.mean((model(_t(x[rows])) - _t(y[rows])) ** 2)
        named = canonical_params(model)
        grads = torch.autograd.grad(loss, list(named.values()))
        with torch.no_grad():
            for t, g in zip(named.values(), grads):
                t -= LR * _all_reduce(g, "dp", average=True)
        loss = _all_reduce(loss, "dp", average=True)
    return float(loss.item())


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def dp_pp() -> float:
    """``_dryrun_dp_pp``: a ``tanh(x·w + b)`` stage a rank of ``pp`` (4,
    or 2 when the world is not a multiple of 4), 6 microbatches of 2
    rows a ``dp`` row; the mean squared error of the pipeline's output
    and one SGD step on gradients averaged over ``dp``; returns the loss
    before the step, averaged over ``dp``."""
    n = core.size()
    pp = 4 if n % 4 == 0 else 2
    dp = n // pp
    d, m, mb = 8, 6, 2
    rng = np.random.default_rng(3)
    stages = [{"w": rng.normal(size=(d, d)).astype(np.float32) * 0.5,
               "b": rng.normal(size=(d,)).astype(np.float32) * 0.1}
              for _ in range(pp)]
    x = rng.normal(size=(dp, m, mb, d)).astype(np.float32)
    tgt = rng.normal(size=(dp, m, mb, d)).astype(np.float32)
    mesh = make_mesh((dp, pp), ("dp", "pp"))
    row = mesh.get_local_rank("dp")
    with use_mesh(mesh):
        stacked = stack_stage_params([{k: _t(v, grad=True) for k, v in
                                       st.items()} for st in stages])
        mine = stage_params(stacked, "pp")
        out = pipeline_apply(_stage_fn, mine, _t(x[row]), axis="pp")
        loss = torch.mean((out - _t(tgt[row])) ** 2)
        grads = torch.autograd.grad(loss, list(mine.values()))
        _sgd(mine, [_all_reduce(g, "dp", average=True) for g in grads])
        loss = _all_reduce(loss, "dp", average=True)
    return float(loss.item())


def _expert_fn(p, x):
    return torch.tanh(x @ p["w"]) @ p["v"]


def ep() -> float:
    """``_dryrun_ep``: a top-1 MoE layer (``tanh(x·w)·v`` experts, one a
    rank, capacity 8) over ``ep``, the world (the reference takes up to
    8 devices), 8 tokens a rank; the mean squared error, gradients
    summed over ``ep`` and one SGD step; returns the loss before the
    step, summed over ``ep``."""
    n = core.size()
    if n > 8:
        raise ValueError(f"the ep drive spans at most 8 ranks, not {n}")
    d, n_local = 8, 8
    rng = np.random.default_rng(4)
    params = {
        "w": rng.normal(size=(n, d, 16)).astype(np.float32) * 0.5,
        "v": rng.normal(size=(n, 16, d)).astype(np.float32) * 0.5,
        "router": rng.normal(size=(d, n)).astype(np.float32),
    }
    x = rng.normal(size=(n, n_local, d)).astype(np.float32)
    tgt = rng.normal(size=(n, n_local, d)).astype(np.float32)
    mesh = make_mesh((n,), ("ep",))
    r = mesh.get_local_rank("ep")
    with use_mesh(mesh):
        p = {k: _t(v, grad=True) for k, v in params.items()}
        mine = {k: p[k][r:r + 1] for k in ("w", "v")}
        out = moe_apply(_expert_fn, mine, _t(x[r]), p["router"],
                        capacity=n_local, axis="ep")
        loss = torch.mean((out - _t(tgt[r])) ** 2)
        grads = torch.autograd.grad(loss, list(p.values()))
        _sgd(p, [_all_reduce(g, "ep") for g in grads])
        loss = _all_reduce(loss, "ep")
    return float(loss.item())


def _tp_stage_fn(p, x):
    # column-parallel in (f before it), row-parallel out (g after it)
    h = torch.tanh(copy_to_tp(x) @ p["w1"] + p["b1"])
    return reduce_from_tp(h @ p["w2"])


def dp_tp_pp() -> float:
    """``_dryrun_dp_tp_pp``: a ``(dp, 2, 2)`` mesh of ``(dp, pp, tp)``:
    each ``dp`` row a 2-stage pipeline whose every stage is a Megatron
    MLP over ``tp`` (``w1`` column-, ``w2`` row-parallel), 4
    microbatches of 2 rows; the mean squared error and one SGD step on
    gradients averaged over ``dp``; returns the loss before the step,
    averaged over ``dp``."""
    pp, tp = 2, 2
    dp = core.size() // (pp * tp)
    d, hidden, m, mb = 8, 8, 4, 2
    rng = np.random.default_rng(5)
    params = {
        "w1": rng.normal(size=(pp, d, hidden)).astype(np.float32) * 0.5,
        "b1": rng.normal(size=(pp, hidden)).astype(np.float32) * 0.1,
        "w2": rng.normal(size=(pp, hidden, d)).astype(np.float32) * 0.5,
    }
    x = rng.normal(size=(dp, m, mb, d)).astype(np.float32)
    tgt = rng.normal(size=(dp, m, mb, d)).astype(np.float32)
    mesh = make_mesh((dp, pp, tp), ("dp", "pp", "tp"))
    row, stage, col = (mesh.get_local_rank(a) for a in ("dp", "pp", "tp"))
    cols = slice(col * hidden // tp, (col + 1) * hidden // tp)
    with use_mesh(mesh):
        mine = {"w1": _t(params["w1"][stage][:, cols], grad=True),
                "b1": _t(params["b1"][stage][cols], grad=True),
                "w2": _t(params["w2"][stage][cols], grad=True)}
        out = pipeline_apply(_tp_stage_fn, mine, _t(x[row]), axis="pp")
        loss = torch.mean((out - _t(tgt[row])) ** 2)
        grads = torch.autograd.grad(loss, list(mine.values()))
        _sgd(mine, [_all_reduce(g, "dp", average=True) for g in grads])
        loss = _all_reduce(loss, "dp", average=True)
    return float(loss.item())


#: the drives by the names the reference's dry run prints
DRIVES = {"dp x sp": dp_sp, "dp x tp": dp_tp, "dp x pp": dp_pp, "ep": ep,
          "dp x tp x pp": dp_tp_pp}
