"""Fused optimizer update: one flat elementwise kernel per step.

The port of ``horovod_tpu/optim/fused_update.py``.  Gradients and
parameters are flattened into ONE contiguous buffer per dtype and the
whole SGD / momentum / Adam update runs as a single kernel over it — K1,
``csrc/fused_update.cu``, on CUDA tensors; on CPU tensors the plain
PyTorch version beside it, which is also the kernel's yardstick on the
card.  The math is the reference's, expression for expression, so the
results match it to float32 rounding:

* ``sgd``      — ``p + (-lr) * g``
* ``momentum`` — ``t = m*t + g;  p + (-lr) * t`` (optax ``trace``)
* ``adam``     — optax ``scale_by_adam``: ``(1-b)·g + b·m`` moments and
  ``1 / (1 - b**count)`` bias corrections

The optimizer state is the flat layout itself (:class:`FusedOptState`:
per-dtype flat moment buffers plus the step count), shared by the fused
path (:meth:`FusedOptimizer.fused_update`) and the per-leaf path
(:meth:`FusedOptimizer.update`), which compute identical numbers.

In place: unlike the reference, which returns fresh arrays, both paths
write the new moments into the state's flat buffers and advance its
count in place, and the fused path writes the new parameters back into
the given parameter tensors.  That is the port's form of buffer
donation: a step holds one copy of the optimizer state, at addresses
that never change, so a CUDA graph of the step stays bound to it.

Everything that changes from step to step lives on the device, in the
state: the count is an int32 scalar tensor, as in the reference, and
Adam's bias corrections are computed from it on the device, in float32
in the reference's order (``_bias_corrections``), into each group's
2-float ``bc`` buffer, which K1 reads when it runs.  The optimizer holds
only the constant scalars, rounded once, when it is built.

Each update of a flat group is one launch of K1 (:func:`flat_update_`),
the ``torch.library`` op ``hvd::fused_update`` while a dispatch mode is
on: K1 on CUDA tensors, the plain version on CPU tensors, so a
``make_fx`` trace of a train step shows each launch as one node and
``FlopCounterMode`` counts it (:data:`K1_FLOPS_PER_ELEMENT`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from .. import kernels
from ..utils.tree import tree_flatten, tree_unflatten

#: the supported update rules
SGD, MOMENTUM, ADAM = "sgd", "momentum", "adam"
#: the parameter-group types whose constants an optimizer rounds when it
#: is built
_FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


class FusedOptState(NamedTuple):
    """Flat optimizer state: ``count`` (the optax-style step counter, an
    int32 scalar tensor on the parameters' device) plus per-dtype-group
    moment buffers keyed by dtype name (``{"float32": flat}``) and, for
    Adam, each group's float32 ``[inv_bc1, inv_bc2]`` of the current step
    (``bc``), refilled in place from ``count``.  SGD carries empty
    dicts."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    bc: Dict[str, torch.Tensor]


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"``, the reference's group key."""
    return str(dtype).rsplit(".", 1)[-1]


# ---------------------------------------------------------------------------
# flat layout
# ---------------------------------------------------------------------------
def _group_leaves(tree) -> Tuple[Dict[str, List[int]], List[Any], Any]:
    """Leaves grouped by dtype name, indices in flatten order."""
    leaves, treedef = tree_flatten(tree)
    groups: Dict[str, List[int]] = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(dtype_name(leaf.dtype), []).append(i)
    return groups, leaves, treedef


def flatten_by_dtype(tree) -> Tuple[Dict[str, torch.Tensor], Any]:
    """``{dtype_name: 1-D flat copy}`` plus the metadata that inverts it
    (:func:`unflatten_by_dtype`, :func:`copy_from_flat_`).  Each leaf
    contributes its elements in logical (row-major) order, whatever its
    memory format."""
    groups, leaves, treedef = _group_leaves(tree)
    flat = {name: torch.cat([leaves[i].reshape(-1) for i in idxs])
            for name, idxs in groups.items()}
    meta = (groups, [tuple(leaf.shape) for leaf in leaves], treedef)
    return flat, meta


def _split(flat: Dict[str, torch.Tensor], meta) -> List[torch.Tensor]:
    groups, shapes, _ = meta
    leaves: List[Any] = [None] * len(shapes)
    for name, idxs in groups.items():
        offset = 0
        for i in idxs:
            size = int(np.prod(shapes[i], dtype=np.int64))
            leaves[i] = flat[name][offset:offset + size].view(shapes[i])
            offset += size
    return leaves


def unflatten_by_dtype(flat: Dict[str, torch.Tensor], meta):
    """The tree back, its leaves views of the flat buffers."""
    return tree_unflatten(meta[2], _split(flat, meta))


def copy_from_flat_(tree, flat: Dict[str, torch.Tensor], meta) -> None:
    """Write the flat buffers back into the tree's own tensors, in
    place."""
    leaves, _ = tree_flatten(tree)
    with torch.no_grad():
        for dst, src in zip(leaves, _split(flat, meta)):
            dst.copy_(src)


def bc_buffers(nu: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Adam's ``bc`` buffer of each group of ``nu`` (``{}`` for the other
    rules, which carry no ``nu``), on the group's device; every step
    fills it before K1 reads it."""
    return {name: torch.zeros(2, dtype=torch.float32, device=t.device)
            for name, t in nu.items()}


# ---------------------------------------------------------------------------
# the update math — ONE definition per rule, returning the optax-style
# UPDATE (delta) plus new moments; the plain flat versions and the
# per-leaf path both use these.  The constants are Python floats and the
# bias corrections 0-d float32 tensors, each holding a value of the
# group's type, so torch rounds nothing further when it takes them.
# ---------------------------------------------------------------------------
def _sgd_update(g, lr):
    return (-lr) * g


def _momentum_update(g, t, lr, m):
    t = m * t + g
    return (-lr) * t, t


def _adam_update(g, mu, nu, lr, b1, b2, eps, one_minus_b1, one_minus_b2,
                 inv_bc1, inv_bc2):
    mu = one_minus_b1 * g + b1 * mu
    nu = one_minus_b2 * (g * g) + b2 * nu
    step = (mu * inv_bc1) / (torch.sqrt(nu * inv_bc2) + eps)
    return (-lr) * step, mu, nu


# -- the plain versions of K1: same math over the flat buffers, in place ----
def plain_sgd_(p, g, *, lr):
    p.copy_(p + _sgd_update(g, lr))


def plain_momentum_(p, g, t, *, lr, momentum):
    u, t_new = _momentum_update(g, t, lr, momentum)
    t.copy_(t_new)
    p.copy_(p + u)


def plain_adam_(p, g, mu, nu, *, lr, b1, b2, eps, one_minus_b1,
                one_minus_b2, bc):
    u, mu_new, nu_new = _adam_update(g, mu, nu, lr, b1, b2, eps,
                                     one_minus_b1, one_minus_b2, bc[0],
                                     bc[1])
    mu.copy_(mu_new)
    nu.copy_(nu_new)
    p.copy_(p + u)


def _plain_update_(kind: str, p, g, mu, nu, **scalars) -> None:
    if kind == SGD:
        plain_sgd_(p, g, **scalars)
    elif kind == MOMENTUM:
        plain_momentum_(p, g, mu, **scalars)
    else:
        plain_adam_(p, g, mu, nu, **scalars)


# ---------------------------------------------------------------------------
# K1 as the torch.library op ``hvd::fused_update``: the kernel for CUDA
# tensors, its plain version for CPU tensors, a fake that writes nothing
# (shapes are unchanged) and a FLOP formula, so torch.fx traces one node
# per launch and FlopCounterMode counts it
# ---------------------------------------------------------------------------
#: each rule's scalars, in the op's argument order
_K1_SCALARS = ("lr", "momentum", "b1", "b2", "eps", "one_minus_b1",
               "one_minus_b2")
#: FLOPs per element of each rule, as the plain version and the kernel
#: compute it: sgd p + (-lr)·g; momentum t = m·t + g, p + (-lr)·t; adam
#: both moments (3 + 4), the bias-corrected step (mul, mul, sqrt, add,
#: div) and p + (-lr)·step
K1_FLOPS_PER_ELEMENT = {SGD: 2, MOMENTUM: 4, ADAM: 14}

_LIB = torch.library.Library("hvd", "FRAGMENT")
_LIB.define(
    "fused_update(str kind, Tensor(a!) p, Tensor g, Tensor(b!)? mu, "
    "Tensor(c!)? nu, Tensor? bc, float lr, float momentum, float b1, "
    "float b2, float eps, float one_minus_b1, float one_minus_b2) -> ()")


def _op_scalars(kind: str, bc, values) -> dict:
    names = {SGD: ("lr",), MOMENTUM: ("lr", "momentum"),
             ADAM: ("lr", "b1", "b2", "eps", "one_minus_b1",
                    "one_minus_b2")}[kind]
    scalars = {n: v for n, v in zip(_K1_SCALARS, values) if n in names}
    if kind == ADAM:
        scalars["bc"] = bc
    return scalars


def _fused_update_cpu(kind, p, g, mu, nu, bc, *values) -> None:
    _plain_update_(kind, p, g, mu, nu, **_op_scalars(kind, bc, values))


def _fused_update_cuda(kind, p, g, mu, nu, bc, *values) -> None:
    kernels.launch_fused_update(kind, p, g, mu, nu,
                                **_op_scalars(kind, bc, values))


_LIB.impl("fused_update", _fused_update_cpu, "CPU")
_LIB.impl("fused_update", _fused_update_cuda, "CUDA")
torch.library.register_fake("hvd::fused_update",
                            lambda *args: None, lib=_LIB)


@register_flop_formula(torch.ops.hvd.fused_update)
def _fused_update_flops(kind, p_shape, *args, out_shape=None, **kw) -> int:
    del args, out_shape, kw
    return K1_FLOPS_PER_ELEMENT[kind] * int(np.prod(p_shape))


def flat_update_(kind: str, p, g, mu=None, nu=None, **scalars) -> None:
    """One rule over flat buffers, in place: the plain version for CPU
    tensors, K1 for any other — as the op ``hvd::fused_update`` while a
    dispatch mode (make_fx, FlopCounterMode) is on, through the wrapper
    itself otherwise.  A tensor that K1 does not take raises; nothing
    falls back."""
    if kind not in K1_FLOPS_PER_ELEMENT:
        raise ValueError(f"unknown fused update rule {kind!r}")
    if _get_current_dispatch_mode() is None:
        # nothing traces or counts: skip the dispatcher
        if p.device.type == "cpu":
            _plain_update_(kind, p, g, mu, nu, **scalars)
        else:
            kernels.launch_fused_update(kind, p, g, mu, nu, **scalars)
        return
    torch.ops.hvd.fused_update(
        kind, p, g, mu, nu, scalars.get("bc"),
        *(float(scalars.get(n, 0.0)) for n in _K1_SCALARS))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FusedOptimizer:
    """A fusable SGD / momentum / Adam optimizer with the reference's
    surface: ``init``, the per-leaf ``update`` (optax signature) and the
    fused ``fused_update``, over one shared flat state layout."""

    kind: str = SGD
    learning_rate: float = 0.01
    momentum: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __post_init__(self):
        if self.kind not in (SGD, MOMENTUM, ADAM):
            raise ValueError(f"unknown fused optimizer kind {self.kind!r}")
        # the constants of a group of each type, rounded once
        object.__setattr__(self, "_constants", {
            dtype: self._round_constants(dtype) for dtype in _FLOAT_TYPES})

    def _round_constants(self, dtype: torch.dtype) -> dict:
        """The rule's constant scalars for a group of ``dtype``, each
        rounded to it, as the reference rounds them."""
        def rnd(x) -> float:
            return torch.tensor(float(x), dtype=dtype).item()

        lr = rnd(self.learning_rate)
        if self.kind == SGD:
            return {"lr": lr}
        if self.kind == MOMENTUM:
            return {"lr": lr, "momentum": rnd(self.momentum)}
        b1, b2 = rnd(self.b1), rnd(self.b2)
        return {"lr": lr, "b1": b1, "b2": b2, "eps": rnd(self.eps),
                "one_minus_b1": rnd(1.0 - b1), "one_minus_b2": rnd(1.0 - b2)}

    # -- state ---------------------------------------------------------------
    def init(self, params) -> FusedOptState:
        groups, leaves, _ = _group_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")

        def zeros():
            return {name: torch.zeros(
                sum(leaves[i].numel() for i in idxs),
                dtype=leaves[idxs[0]].dtype, device=leaves[idxs[0]].device)
                for name, idxs in groups.items()}

        mu = zeros() if self.kind in (MOMENTUM, ADAM) else {}
        nu = zeros() if self.kind == ADAM else {}
        return FusedOptState(
            count=torch.zeros((), dtype=torch.int32, device=device), mu=mu,
            nu=nu, bc=bc_buffers(nu))

    def bias_corrections(self, count: torch.Tensor, dtype: torch.dtype
                         ) -> torch.Tensor:
        """Adam's ``[1 / (1 - b1**count), 1 / (1 - b2**count)]`` on
        ``count``'s device, computed there in float32 in the reference's
        order (``_bias_corrections``), each rounded to ``dtype`` and
        returned as float32."""
        c = count.float()
        return torch.stack([(1.0 / (1.0 - torch.pow(b, c))).to(dtype)
                            for b in (self.b1, self.b2)]).float()

    def _step_scalars(self, count: torch.Tensor, dtype: torch.dtype,
                      bc: Optional[torch.Tensor] = None) -> dict:
        """The scalars of the step at ``count`` for a group of ``dtype``:
        the constants and, for Adam, ``bc``, the bias corrections computed
        on ``count``'s device — written into the group's ``bc`` buffer
        when one is given (read in stream order by the launch that
        follows), else a new tensor."""
        scalars = self._constants[dtype]
        if self.kind != ADAM:
            return scalars
        corrections = self.bias_corrections(count, dtype)
        if bc is None:
            return {**scalars, "bc": corrections}
        bc.copy_(corrections)
        return {**scalars, "bc": bc}

    # -- the fused path (one kernel per dtype group) -------------------------
    def fused_update(self, grads, state: FusedOptState, params):
        """``(params, state)``: flatten, one K1 launch per dtype group,
        write back.  ``params``, the state's moment buffers and its count
        are updated in place and returned."""
        with torch.no_grad():
            pf, meta = flatten_by_dtype(params)
            gf, _ = flatten_by_dtype(grads)
            state.count.add_(1)
            for name, p in pf.items():
                flat_update_(self.kind, p, gf[name].to(p.dtype),
                             state.mu.get(name), state.nu.get(name),
                             **self._step_scalars(state.count, p.dtype,
                                                  state.bc.get(name)))
            copy_from_flat_(params, pf, meta)
        return params, state

    # -- the per-leaf path (optax-compatible) --------------------------------
    def update(self, grads, state: FusedOptState, params=None):
        """optax signature: ``(updates, state)`` by per-leaf traversal —
        the unfused side of the ``fused_optimizer`` knob.  Same math, same
        flat state layout: each leaf's new moments are written into its
        slice of the state's flat buffers, and the count advances in
        place."""
        del params
        with torch.no_grad():
            groups, g_leaves, treedef = _group_leaves(grads)
            state.count.add_(1)
            upd: List[Any] = [None] * len(g_leaves)
            for name, idxs in groups.items():
                s = self._step_scalars(state.count, g_leaves[idxs[0]].dtype,
                                       state.bc.get(name))
                offs = np.cumsum([0] + [g_leaves[i].numel() for i in idxs])
                for j, i in enumerate(idxs):
                    g = g_leaves[i]
                    if self.kind == SGD:
                        upd[i] = _sgd_update(g, s["lr"])
                        continue
                    mu = state.mu[name][offs[j]:offs[j + 1]].view(g.shape)
                    if self.kind == MOMENTUM:
                        upd[i], mu_new = _momentum_update(g, mu, s["lr"],
                                                          s["momentum"])
                    else:
                        nu = state.nu[name][offs[j]:offs[j + 1]].view(g.shape)
                        upd[i], mu_new, nu_new = _adam_update(
                            g, mu, nu, s["lr"], s["b1"], s["b2"], s["eps"],
                            s["one_minus_b1"], s["one_minus_b2"],
                            s["bc"][0], s["bc"][1])
                        nu.copy_(nu_new)
                    mu.copy_(mu_new)
        return tree_unflatten(treedef, upd), state


def apply_updates(params, updates) -> None:
    """``optax.apply_updates`` in place: ``p += u`` for every leaf."""
    with torch.no_grad():
        for p, u in zip(tree_flatten(params)[0], tree_flatten(updates)[0]):
            p.add_(u.to(p.dtype))


def fused_sgd(learning_rate: float, momentum: float = 0.0,
              **kw) -> FusedOptimizer:
    return FusedOptimizer(kind=MOMENTUM if momentum else SGD,
                          learning_rate=learning_rate, momentum=momentum,
                          **kw)


def fused_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, **kw) -> FusedOptimizer:
    return FusedOptimizer(kind=ADAM, learning_rate=learning_rate, b1=b1,
                          b2=b2, eps=eps, **kw)
