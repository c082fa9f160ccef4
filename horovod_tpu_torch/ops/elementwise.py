"""The ResNet elementwise joins: the port of
``horovod_tpu/ops/elementwise.py``.

Four kernels carry them, written by hand for Hopper in
``csrc/elementwise.cu`` and launched through ``kernels.py`` on the loop
``kernels.elementwise_plan`` picks:

* K7, ``relu(x + y)`` in x's dtype (the reference's
  ``_residual_relu_kernel``): the block output's residual join,
  ``ResNet(residual_join="pallas")``; its backward is K6′;
* K6, ``relu(x · scale + bias)`` per channel in float32, cast back
  (``_scale_bias_relu_kernel``): the norm+activation join,
  ``ResNet(norm_act="pallas")``, on a loop whose threads each keep one
  channel pack's scale and bias in registers;
* K6′, ``where(out > 0, g, 0)`` with the compare in float32
  (``_relu_grad_kernel``): K7's backward;
* K6's backward (the reference's ``_scale_bias_relu_bwd``: the mask
  kernel, then a float32 jnp tail that XLA fuses): one pass that reads x,
  out and g once and writes ``dx = gm·scale`` and each block's
  ``Σ gm·x`` and ``Σ gm``, then a second pass that adds the blocks' sums
  in a fixed order, with no atomics, so two calls give the same bits.

Beside each is its plain PyTorch version (:func:`plain_residual_relu`,
:func:`plain_scale_bias_relu`, :func:`plain_relu_grad`,
:func:`plain_scale_bias_relu_bwd`), which rounds where the Pallas body
rounds, so a kernel and its plain version agree bit for bit (the
backward's float32 sums to float32 summation order).  CPU tensors take the
plain version; any other tensor goes to the kernel, which raises on what
it does not take.  Nothing falls back.

Public functions keep the reference's layout: any shape with channels
last, the kernels seeing it as a contiguous ``[rows, C]``.  The port's
NCHW activations are views of NHWC memory, so ``models/resnet.py`` hands
``x.permute(0, 2, 3, 1)`` over with no copy.  The reference's
``block_rows`` and ``interpret`` are TPU tiling and have no counterpart.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from .. import kernels


# ---------------------------------------------------------------------------
# plain versions of K6, its backward, K6' and K7
# ---------------------------------------------------------------------------
def plain_residual_relu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K7's plain version: the sum rounded once to x's dtype, then the
    max with 0."""
    return (x + y).clamp_min(0)


def plain_relu_grad(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K6′'s plain version: ``g`` where ``float(out) > 0``, else 0."""
    return torch.where(out.float() > 0, g, torch.zeros_like(g))


def plain_scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """K6's plain version: ``float(x) · scale`` rounded, ``+ bias``
    rounded, the max with 0, then the cast to x's dtype."""
    return (x.float() * scale + bias).clamp_min(0).to(x.dtype)


def plain_scale_bias_relu_bwd(x: torch.Tensor, scale: torch.Tensor,
                              out: torch.Tensor, g: torch.Tensor):
    """K6's backward's plain version, the reference's
    ``_scale_bias_relu_bwd``: ``gm`` = K6′'s plain version in float32,
    then ``dx = gm·scale`` cast to x's dtype, ``dscale = Σ gm·x`` and
    ``dbias = Σ gm`` over every axis but the channels', in float32."""
    gm32 = plain_relu_grad(out, g).float()
    axes = tuple(range(x.dim() - 1))
    return ((gm32 * scale).to(x.dtype), (gm32 * x.float()).sum(dim=axes),
            gm32.sum(dim=axes))


# ---------------------------------------------------------------------------
# dispatch: the plain version for CPU tensors, the kernel for any other.
# K7, K6', K6 and K6's backward are also the torch.library ops
# ``hvd::residual_relu``, ``hvd::relu_grad``, ``hvd::scale_bias_relu`` and
# ``hvd::scale_bias_relu_bwd`` (CPU: the plain version, CUDA: the kernel,
# a fake and a FLOP formula), taken while a dispatch mode (make_fx,
# FlopCounterMode) is on.
# ---------------------------------------------------------------------------
#: FLOPs per element of the first operand: K7 an add and a max, K6' a
#: select, K6 a multiply, an add and a max, K6's backward a select, dx's
#: multiply, dscale's multiply and add and dbias's add
EW_FLOPS_PER_ELEMENT = {"residual_relu": 2, "relu_grad": 1,
                        "scale_bias_relu": 3, "scale_bias_relu_bwd": 5}


def _sums_like(x: torch.Tensor) -> torch.Tensor:
    return x.new_empty(x.shape[-1:], dtype=torch.float32)


#: each op's schema, plain version, kernel wrapper and fake
_EW_OPS = {
    "residual_relu": ("(Tensor x, Tensor y) -> Tensor", plain_residual_relu,
                      kernels.launch_residual_relu,
                      lambda x, y: torch.empty_like(x)),
    "relu_grad": ("(Tensor out, Tensor g) -> Tensor", plain_relu_grad,
                  kernels.launch_relu_grad,
                  lambda out, g: torch.empty_like(g)),
    "scale_bias_relu": ("(Tensor x, Tensor scale, Tensor bias) -> Tensor",
                        plain_scale_bias_relu,
                        kernels.launch_scale_bias_relu,
                        lambda x, scale, bias: torch.empty_like(x)),
    "scale_bias_relu_bwd": (
        "(Tensor x, Tensor scale, Tensor out, Tensor g) -> "
        "(Tensor, Tensor, Tensor)", plain_scale_bias_relu_bwd,
        kernels.launch_scale_bias_relu_bwd,
        lambda x, scale, out, g: (torch.empty_like(x), _sums_like(x),
                                  _sums_like(x))),
}

_LIB = torch.library.Library("hvd", "FRAGMENT")
for _name, (_schema, _plain, _kernel, _fake) in _EW_OPS.items():
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _plain, "CPU")
    _LIB.impl(_name, _kernel, "CUDA")
    torch.library.register_fake(f"hvd::{_name}", _fake, lib=_LIB)
    register_flop_formula(getattr(torch.ops.hvd, _name))(
        (lambda n: lambda first, *a, **kw: n * math.prod(first))(
            EW_FLOPS_PER_ELEMENT[_name]))


def _ew_op(name: str, *args):
    if _get_current_dispatch_mode() is None:
        _, plain, kernel, _ = _EW_OPS[name]
        return (plain if args[0].device.type == "cpu" else kernel)(*args)
    return getattr(torch.ops.hvd, name)(*args)


def _residual_relu(x, y):
    return _ew_op("residual_relu", x, y)


def _relu_grad(out, g):
    return _ew_op("relu_grad", out, g)


def _scale_bias_relu(x, scale, bias):
    return _ew_op("scale_bias_relu", x, scale, bias)


def _scale_bias_relu_bwd(x, scale, out, g):
    return _ew_op("scale_bias_relu_bwd", x, scale, out, g)


def autocast_off(t: torch.Tensor):
    """Autocast disabled on ``t``'s device: the joins cast their operands
    themselves, and their float32 arithmetic stays float32."""
    return torch.autocast("cuda" if t.is_cuda else "cpu", enabled=False)


def _like_out(g: torch.Tensor) -> torch.Tensor:
    """The upstream gradient in the saved output's channels-last layout.
    The gradient of the last block's output comes from ``x.mean((2, 3))``,
    whose backward hands an expanded tensor with zero strides; that one
    (or any other non-contiguous gradient) is copied here, explicitly,
    into the layout the kernels take."""
    return g if g.is_contiguous() else g.contiguous()


class _ResidualRelu(torch.autograd.Function):
    """K7 forward; K6′ on the saved output backward, the same gradient
    for both inputs (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, x, y):
        out = _residual_relu(x, y)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        dx = _relu_grad(out, _like_out(g))
        return dx, dx


class _ScaleBiasRelu(torch.autograd.Function):
    """K6 forward; backward K6's backward kernel: ``gm = where(out > 0,
    g, 0)``, ``dx = gm·scale`` in x's dtype and ``dscale = Σ gm·x``,
    ``dbias = Σ gm`` over the non-channel axes in float32, as the
    reference's custom VJP."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        out = _scale_bias_relu(x, scale, bias)
        ctx.save_for_backward(x, scale, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, out = ctx.saved_tensors
        dx, dscale, dbias = _scale_bias_relu_bwd(x, scale, out, _like_out(g))
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype)


def residual_relu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``relu(x + y)`` as one pass (K7), differentiable: the backward is
    one masked pass (K6′) over the saved output.  ``x`` and ``y``: the
    same shape, channels last."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    with autocast_off(x):
        return _ResidualRelu.apply(x, y)


def scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """``relu(x · scale + bias)`` as one pass (K6), its backward one pass
    and a second over the blocks' sums: the folded norm+activation join.
    ``x``: any shape with channels last; ``scale`` / ``bias``: float32
    ``[C]``.  Gradients reach ``scale`` and ``bias``, so a caller that
    computes them from batch statistics gets the full BatchNorm backward
    through autograd."""
    c = x.shape[-1]
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"scale/bias must be [{c}], got "
                         f"{tuple(scale.shape)} / {tuple(bias.shape)}")
    with autocast_off(x):
        return _ScaleBiasRelu.apply(x, scale, bias)
