"""Names and layouts between the JAX package's state and the port's.

The port's parameters keep PyTorch's layouts (conv ``OIHW``, linear
``[out, in]``) under torch's names (``weight``, ``running_mean``...);
the reference's flax state keeps ``HWIO`` / ``[in, out]`` under flax
names (``kernel``, ``scale``, ``mean``...).  This module maps one onto
the other.

The port's **canonical leaf order** is the reference's: the flax paths
(``BottleneckBlock_0/Conv_1/kernel``) sorted the way ``jax.tree_util``
flattens nested dicts, so ``BottleneckBlock_10`` comes before
``BottleneckBlock_2``.  :func:`canonical_params` lists a module's
parameters in that order under those names; the training state, the
fusion buckets and the flat optimizer buffers all follow it, so the
port's bucket lists equal the reference's, and its flat moment buffers
equal the reference's once each leaf is transposed
(:func:`fused_opt_state_from_flax`).

Arrays cross as numpy: nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .models.layers import BatchNorm
from .optim.fused_update import FusedOptState, dtype_name
from .utils.tree import tree_flatten_with_path

_PARAM_NAMES = {"weight": "kernel", "bias": "bias"}
_BN_PARAM_NAMES = {"weight": "scale", "bias": "bias"}
_BN_BUFFER_NAMES = {"running_mean": "mean", "running_var": "var"}


def _path_key(name: str) -> Tuple[str, ...]:
    return tuple(name.split("/"))


def _collect(model: nn.Module, buffers: bool) -> Dict[str, torch.Tensor]:
    out = {}
    for mod_name, mod in model.named_modules():
        prefix = mod_name.replace(".", "/")
        if buffers:
            names = _BN_BUFFER_NAMES if isinstance(mod, BatchNorm) else {}
            items = mod.named_buffers(recurse=False)
        else:
            names = _BN_PARAM_NAMES if isinstance(mod, BatchNorm) \
                else _PARAM_NAMES
            items = mod.named_parameters(recurse=False)
        for local, t in items:
            if local not in names:
                raise ValueError(
                    f"no flax name for {type(mod).__name__}.{local}")
            out[f"{prefix}/{names[local]}" if prefix else names[local]] = t
    return {k: out[k] for k in sorted(out, key=_path_key)}


def canonical_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters (the tensors themselves) keyed by flax
    path, in the reference's leaf order."""
    return _collect(model, buffers=False)


def canonical_batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The BatchNorm running statistics keyed by flax path
    (``bn_init/mean``), in the reference's leaf order."""
    return _collect(model, buffers=True)


def to_torch_layout(a: np.ndarray) -> np.ndarray:
    """flax → torch: conv ``HWIO`` → ``OIHW``, dense ``[in, out]`` →
    ``[out, in]``; vectors unchanged."""
    if a.ndim == 4:
        return np.transpose(a, (3, 2, 0, 1))
    if a.ndim == 2:
        return a.T
    return a


def to_flax_layout(a: np.ndarray) -> np.ndarray:
    """torch → flax, the inverse of :func:`to_torch_layout`."""
    if a.ndim == 4:
        return np.transpose(a, (2, 3, 1, 0))
    if a.ndim == 2:
        return a.T
    return a


def flatten_flax(tree: Mapping) -> Dict[str, np.ndarray]:
    """A nested flax dict as ``{"a/b/kernel": numpy array}``, in leaf
    order."""
    return {"/".join(path): np.asarray(leaf)
            for path, leaf in tree_flatten_with_path(dict(tree))}


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping = None) -> None:
    """Copy the reference's ``params`` (and ``batch_stats``) into the
    module, in place, transposing to torch's layouts.  Every name must
    match both ways."""
    pairs = [(canonical_params(model), flatten_flax(params))]
    if batch_stats is not None:
        pairs.append((canonical_batch_stats(model), flatten_flax(batch_stats)))
    with torch.no_grad():
        for ours, theirs in pairs:
            if set(ours) != set(theirs):
                raise ValueError(
                    "flax and torch names differ: only flax "
                    f"{sorted(set(theirs) - set(ours))[:5]}, only torch "
                    f"{sorted(set(ours) - set(theirs))[:5]}")
            for name, t in ours.items():
                src = to_torch_layout(theirs[name])
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"{name}: flax {theirs[name].shape} vs "
                                     f"torch {tuple(t.shape)}")
                t.copy_(torch.from_numpy(np.array(src)))


def export_flax_variables(tree: Mapping[str, torch.Tensor]
                          ) -> Dict[str, np.ndarray]:
    """A canonical dict of the port's tensors as flax-layout numpy
    arrays, same keys."""
    return {k: to_flax_layout(v.detach().cpu().numpy())
            for k, v in tree.items()}


def _flax_shape(t: torch.Tensor) -> Tuple[int, ...]:
    s = tuple(t.shape)
    if len(s) == 4:
        return (s[2], s[3], s[1], s[0])
    if len(s) == 2:
        return (s[1], s[0])
    return s


def fused_opt_state_from_flax(count, mu: Mapping, nu: Mapping,
                              params: Mapping[str, torch.Tensor]
                              ) -> FusedOptState:
    """The reference's ``FusedOptState(count, mu, nu)`` (flat numpy
    buffers per dtype name) as the port's, for the port's canonical
    ``params``: each leaf's slice is reshaped to its flax shape,
    transposed to torch's layout and flattened again."""
    by_dtype: Dict[str, list] = {}
    for t in params.values():
        by_dtype.setdefault(dtype_name(t.dtype), []).append(t)

    def convert(flat: Mapping) -> Dict[str, torch.Tensor]:
        out = {}
        for name, buf in flat.items():
            buf = np.asarray(buf)
            parts, offset = [], 0
            for t in by_dtype[name]:
                n = t.numel()
                leaf = buf[offset:offset + n].reshape(_flax_shape(t))
                parts.append(to_torch_layout(leaf).reshape(-1))
                offset += n
            if offset != buf.size:
                raise ValueError(f"{name} buffer holds {buf.size} elements, "
                                 f"the parameters {offset}")
            ref = by_dtype[name][0]
            out[name] = torch.from_numpy(np.concatenate(parts)).to(
                device=ref.device, dtype=ref.dtype)
        return out

    return FusedOptState(count=int(np.asarray(count)), mu=convert(mu),
                         nu=convert(nu))
