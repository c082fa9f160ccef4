"""Names and layouts between the JAX package's state and the port's.

The port's parameters keep PyTorch's layouts (conv ``OIHW``, linear
``[out, in]``) under torch's names (``weight``, ``running_mean``...);
the reference's flax state keeps ``HWIO`` / ``[in, out]`` under flax
names (``kernel``, ``scale``, ``mean``...).  This module maps one onto
the other, with one rule per layer type:

=================  ==================  ===================================
port layer         torch → flax name   layout (flax → torch)
=================  ==================  ===================================
Conv, Dense        weight → kernel     HWIO → OIHW, ``[in, out]`` → ``[out, in]``
BatchNorm,         weight → scale      as is (and running_mean/var →
BatchNormReLU                          mean/var)
PallasConvBN3x3    weight → kernel,    HWIO → OIHW; scale, bias as is (and
                   scale, bias         running_mean/var → mean/var)
LayerNorm          weight → scale      as is
Embed              weight → embedding  as is (``[vocab, features]`` in both)
ViT (its own)      cls, pos_embed      as is (same names)
DenseGeneral       weight → kernel     ``in_shape + out_shape`` →
                                       ``[prod(out), prod(in)]``; bias
                                       ``out_shape`` → ``[prod(out)]``
=================  ==================  ===================================

Each leaf's rule is a :class:`Layout`, decided by its module
(:func:`canonical_layouts`); the functions that see tensors without
their module (:func:`export_flax_variables`,
:func:`fused_opt_state_from_flax`) take those layouts as an argument.

The port's **canonical leaf order** is the reference's: the flax paths
(``BottleneckBlock_0/Conv_1/kernel``) sorted the way ``jax.tree_util``
flattens nested dicts, so ``BottleneckBlock_10`` comes before
``BottleneckBlock_2`` and ``LayerNorm_0`` before ``wpe``.
:func:`canonical_params` lists a module's parameters in that order under
those names; the training state, the fusion buckets and the flat
optimizer buffers all follow it, so the port's bucket lists equal the
reference's, and its flat moment buffers equal the reference's once each
leaf takes its layout (:func:`fused_opt_state_from_flax`).

The model-parallel layers (``parallel/``) have converters of their own:
:func:`parallel_mlp_params_from_flax` (a ``ParallelMLP``, whole or one
rank's tensor-parallel shard), :func:`pipeline_params_from_flax` (a
pipeline's stacked stages) and :func:`moe_params_from_flax` (a MoE
layer's stacked experts, or one rank's, and its router).

Arrays cross as numpy: nothing here imports the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .models.layers import BatchNorm, DenseGeneral, Embed, LayerNorm
from .models.resnet import BatchNormReLU, PallasConvBN3x3
from .models.vit import ViT
from .optim.fused_update import FusedOptState, bc_buffers, dtype_name
from .utils.tree import tree_flatten_with_path

_PARAM_NAMES = {"weight": "kernel", "bias": "bias"}
_NORM_PARAM_NAMES = {"weight": "scale", "bias": "bias"}
_EMBED_PARAM_NAMES = {"weight": "embedding"}
_VIT_PARAM_NAMES = {"cls": "cls", "pos_embed": "pos_embed"}
_FUSED_CONV_PARAM_NAMES = {"weight": "kernel", "scale": "scale",
                           "bias": "bias"}
_BN_BUFFER_NAMES = {"running_mean": "mean", "running_var": "var"}
#: the modules that keep BatchNorm statistics
_STATS_MODULES = (BatchNorm, BatchNormReLU, PallasConvBN3x3)

#: flax HWIO → torch OIHW
_CONV_PERM = (3, 2, 0, 1)


def _rank_perm(ndim: int) -> Tuple[int, ...]:
    if ndim == 4:
        return _CONV_PERM
    if ndim == 2:
        return (1, 0)
    return tuple(range(ndim))


class Layout(NamedTuple):
    """One leaf's rule: the flax array, reshaped to ``merged`` and
    transposed by ``perm``, is the port's tensor."""

    flax_shape: Tuple[int, ...]
    merged: Tuple[int, ...]
    perm: Tuple[int, ...]

    @classmethod
    def of_rank(cls, torch_shape) -> "Layout":
        """The Conv / Dense / vector rule for a tensor of this shape."""
        perm = _rank_perm(len(torch_shape))
        flax = tuple(int(torch_shape[i]) for i in np.argsort(perm))
        return cls(flax, flax, perm)

    @classmethod
    def same(cls, torch_shape) -> "Layout":
        """The same array in both frameworks."""
        shape = tuple(int(n) for n in torch_shape)
        return cls(shape, shape, tuple(range(len(shape))))

    def to_torch(self, a: np.ndarray) -> np.ndarray:
        return np.transpose(np.reshape(a, self.merged), self.perm)

    def to_flax(self, a: np.ndarray) -> np.ndarray:
        return np.reshape(np.transpose(a, np.argsort(self.perm)),
                          self.flax_shape)


def _dense_general_layouts(mod: DenseGeneral) -> Dict[str, Layout]:
    n_in, n_out = math.prod(mod.in_shape), math.prod(mod.out_shape)
    return {"weight": Layout(mod.in_shape + mod.out_shape, (n_in, n_out),
                             (1, 0)),
            "bias": Layout(mod.out_shape, (n_out,), (0,))}


def _rules(mod: nn.Module, buffers: bool):
    """``(flax names, layout of a leaf)`` for a module's own leaves."""
    if buffers:
        return (_BN_BUFFER_NAMES if isinstance(mod, _STATS_MODULES) else {},
                lambda local, t: Layout.same(t.shape))
    if isinstance(mod, (BatchNorm, BatchNormReLU, LayerNorm)):
        return _NORM_PARAM_NAMES, lambda local, t: Layout.same(t.shape)
    if isinstance(mod, Embed):
        return _EMBED_PARAM_NAMES, lambda local, t: Layout.same(t.shape)
    if isinstance(mod, ViT):
        return _VIT_PARAM_NAMES, lambda local, t: Layout.same(t.shape)
    if isinstance(mod, PallasConvBN3x3):
        return _FUSED_CONV_PARAM_NAMES, lambda local, t: Layout.of_rank(
            t.shape)
    if isinstance(mod, DenseGeneral):
        layouts = _dense_general_layouts(mod)
        return _PARAM_NAMES, lambda local, t: layouts[local]
    return _PARAM_NAMES, lambda local, t: Layout.of_rank(t.shape)


def _path_key(name: str) -> Tuple[str, ...]:
    return tuple(name.split("/"))


def _collect(model: nn.Module, buffers: bool
             ) -> Dict[str, Tuple[torch.Tensor, Layout]]:
    out = {}
    for mod_name, mod in model.named_modules():
        prefix = mod_name.replace(".", "/")
        names, layout = _rules(mod, buffers)
        items = (mod.named_buffers(recurse=False) if buffers
                 else mod.named_parameters(recurse=False))
        for local, t in items:
            if local not in names:
                raise ValueError(
                    f"no flax name for {type(mod).__name__}.{local}")
            out[f"{prefix}/{names[local]}" if prefix else names[local]] = \
                (t, layout(local, t))
    return {k: out[k] for k in sorted(out, key=_path_key)}


def canonical_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters (the tensors themselves) keyed by flax
    path, in the reference's leaf order."""
    return {k: t for k, (t, _) in _collect(model, buffers=False).items()}


def canonical_batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The BatchNorm running statistics keyed by flax path
    (``bn_init/mean``), in the reference's leaf order."""
    return {k: t for k, (t, _) in _collect(model, buffers=True).items()}


def canonical_layouts(model: nn.Module) -> Dict[str, Layout]:
    """Each canonical parameter's :class:`Layout`, same keys and order as
    :func:`canonical_params`."""
    return {k: lay for k, (_, lay) in _collect(model, buffers=False).items()}


def to_torch_layout(a: np.ndarray) -> np.ndarray:
    """flax → torch by rank: conv ``HWIO`` → ``OIHW``, dense ``[in, out]``
    → ``[out, in]``; vectors unchanged."""
    return np.transpose(a, _rank_perm(a.ndim))


def to_flax_layout(a: np.ndarray) -> np.ndarray:
    """torch → flax, the inverse of :func:`to_torch_layout`."""
    return np.transpose(a, np.argsort(_rank_perm(a.ndim)))


def flatten_flax(tree: Mapping) -> Dict[str, np.ndarray]:
    """A nested flax dict as ``{"a/b/kernel": numpy array}``, in leaf
    order."""
    return {"/".join(path): np.asarray(leaf)
            for path, leaf in tree_flatten_with_path(dict(tree))}


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping = None) -> None:
    """Copy the reference's ``params`` (and ``batch_stats``) into the
    module, in place, in the port's layouts.  Every name must match both
    ways."""
    pairs = [(_collect(model, buffers=False), flatten_flax(params))]
    if batch_stats is not None:
        pairs.append((_collect(model, buffers=True),
                      flatten_flax(batch_stats)))
    with torch.no_grad():
        for ours, theirs in pairs:
            if set(ours) != set(theirs):
                raise ValueError(
                    "flax and torch names differ: only flax "
                    f"{sorted(set(theirs) - set(ours))[:5]}, only torch "
                    f"{sorted(set(ours) - set(theirs))[:5]}")
            for name, (t, layout) in ours.items():
                if tuple(theirs[name].shape) != layout.flax_shape:
                    raise ValueError(f"{name}: flax {theirs[name].shape} vs "
                                     f"torch {tuple(t.shape)}")
                t.copy_(torch.from_numpy(np.array(
                    layout.to_torch(theirs[name]))))


def _layouts_for(tree: Mapping[str, torch.Tensor],
                 layouts: Mapping[str, Layout]) -> Dict[str, Layout]:
    missing = [k for k in tree if k not in layouts]
    if missing:
        raise ValueError(f"no layout for {missing[:5]}")
    return {k: layouts[k] for k in tree}


def export_flax_variables(tree: Mapping[str, torch.Tensor],
                          layouts: Mapping[str, Layout]
                          ) -> Dict[str, np.ndarray]:
    """A canonical dict of the port's tensors as flax-layout numpy
    arrays, same keys; ``layouts`` is the model's
    :func:`canonical_layouts`."""
    lay = _layouts_for(tree, layouts)
    return {k: lay[k].to_flax(v.detach().cpu().numpy())
            for k, v in tree.items()}


def fused_opt_state_from_flax(count, mu: Mapping, nu: Mapping,
                              params: Mapping[str, torch.Tensor],
                              layouts: Mapping[str, Layout]
                              ) -> FusedOptState:
    """The reference's ``FusedOptState(count, mu, nu)`` (flat numpy
    buffers per dtype name) as the port's, for the port's canonical
    ``params``: each leaf's slice is reshaped to its flax shape, put in
    the port's layout and flattened again; ``layouts`` is the model's
    :func:`canonical_layouts`."""
    lay = _layouts_for(params, layouts)
    by_dtype: Dict[str, list] = {}
    for name, t in params.items():
        by_dtype.setdefault(dtype_name(t.dtype), []).append((t, lay[name]))

    def convert(flat: Mapping) -> Dict[str, torch.Tensor]:
        out = {}
        for name, buf in flat.items():
            buf = np.asarray(buf)
            parts, offset = [], 0
            for t, layout in by_dtype[name]:
                n = t.numel()
                leaf = buf[offset:offset + n].reshape(layout.flax_shape)
                parts.append(layout.to_torch(leaf).reshape(-1))
                offset += n
            if offset != buf.size:
                raise ValueError(f"{name} buffer holds {buf.size} elements, "
                                 f"the parameters {offset}")
            ref = by_dtype[name][0][0]
            out[name] = torch.from_numpy(np.concatenate(parts)).to(
                device=ref.device, dtype=ref.dtype)
        return out

    device = next(iter(params.values())).device if params else "cpu"
    nu = convert(nu)
    return FusedOptState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=device),
        mu=convert(mu), nu=nu, bc=bc_buffers(nu))


# ---------------------------------------------------------------------------
# the model-parallel layers (parallel/)
# ---------------------------------------------------------------------------
def _flat(params: Mapping) -> Dict[str, np.ndarray]:
    """A nested or flat (``"a/b"``-keyed) dict of arrays, flat."""
    if all(not isinstance(v, Mapping) for v in params.values()):
        return {k: np.asarray(v) for k, v in params.items()}
    return flatten_flax(params)


def parallel_mlp_params_from_flax(params: Mapping, *, rank: int = 0,
                                  size: int = 1) -> Dict[str, torch.Tensor]:
    """The reference ``ParallelMLP``'s flax parameters as the port's,
    under its canonical names (``up/kernel`` ...): each kernel ``[in,
    out]`` → ``[out, in]``, then, with ``size > 1``, rank ``rank``'s
    tensor-parallel shard by ``TP_MLP_RULES`` (the whole MLP by
    default)."""
    from .parallel.tensor_parallel import TP_MLP_RULES, shard_leaf, spec_for

    flat = _flat(params)
    if set(flat) != set(TP_MLP_RULES):
        raise ValueError(f"not a ParallelMLP's parameters: {sorted(flat)}")
    return {name: shard_leaf(torch.from_numpy(np.array(to_torch_layout(a))),
                             spec_for(name, TP_MLP_RULES, "tp"), rank, size)
            for name, a in flat.items()}


def pipeline_params_from_flax(stages) -> Dict[str, torch.Tensor]:
    """A pipeline's stage parameters (the reference's per-stage dicts, or
    their ``stack_stage_params`` result) as the port's stacked tensors,
    ``[S, ...]`` a leaf.  The stages' arrays are the stage function's own
    operands (``x @ w``), so their layouts carry over unchanged."""
    if isinstance(stages, Mapping):
        return {k: torch.from_numpy(np.array(v))
                for k, v in _flat(stages).items()}
    return {k: torch.from_numpy(np.stack([np.asarray(s[k]) for s in stages]))
            for k in stages[0]}


def moe_params_from_flax(params: Mapping, *, rank: Optional[int] = None,
                         ep: int = 1) -> Dict[str, object]:
    """A MoE layer's ``{"experts": {leaf: [E, ...]}, "router": [d, E]}``
    (the reference drive's layout) as torch tensors; with ``rank``, the
    experts are that rank's ``E / ep`` only (``moe_apply``'s
    ``expert_params``), the router stays whole.  The arrays are the
    expert function's own operands, so their layouts carry over."""
    experts = {k: np.asarray(v) for k, v in params["experts"].items()}
    if rank is not None:
        per = next(iter(experts.values())).shape[0] // ep
        experts = {k: v[rank * per:(rank + 1) * per]
                   for k, v in experts.items()}
    return {"experts": {k: torch.from_numpy(np.array(v))
                        for k, v in experts.items()},
            "router": torch.from_numpy(np.array(params["router"]))}
