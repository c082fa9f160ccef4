"""The fused 3×3 conv + BatchNorm ops: the port of
``horovod_tpu/ops/conv_bn.py``.

One hand-written Hopper kernel carries them, ``csrc/conv_bn.cu``, an
implicit-GEMM 3×3 SAME stride-1 convolution launched through
``kernels.py`` with one of three epilogues, as the reference's three
Pallas kernels share one body (``_conv_taps``):

* K8, :func:`conv3x3_bn_relu`: ``relu(conv · scale + bias)``, the folded
  BatchNorm affine (the eval forward);
* K9, :func:`conv3x3_stats`: the conv, plus the per-channel sum and sum
  of squares of its float32 accumulator over the batch (the train
  forward);
* K10, :func:`conv3x3_plain`: the conv alone (dx of the train backward,
  on spatially flipped, io-transposed weights).

Beside them are their plain PyTorch versions (:func:`plain_conv3x3_bn_relu`,
:func:`plain_conv3x3_stats`, :func:`plain_conv3x3_plain`), which follow
the Pallas body: the nine shift-and-matmul taps of the padded input,
summed in float32, then the epilogue.  CPU tensors take the plain version;
any other tensor goes to the kernel, which raises on what it does not
take.  Nothing falls back.

:func:`conv3x3_bn_relu_train` is the training op, a
``torch.autograd.Function`` that follows the reference's
``_cbr_fwd_impl`` / ``_cbr_bwd`` step for step; the weight gradient goes
through the framework's convolution (``torch.nn.grad.conv2d_weight``),
as the reference leaves it to XLA's.  :func:`torch_conv3x3_bn_relu` and
:func:`torch_conv3x3_stats` are the reference's XLA twins written with
PyTorch's (cuDNN's) convolution: the library yardstick of the tests and
of ``chip_smoke.py``, never called on the training path.

Public layouts are the reference's: x NHWC ``[B, H, W, Cin]``, w HWIO
``[3, 3, Cin, Cout]``, scale / bias ``[Cout]``.  The reference's
``interpret`` argument has no counterpart.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from .. import kernels
from .elementwise import autocast_off


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or \
            w.shape[2] != x.shape[3]:
        raise ValueError(f"need NHWC x + [3,3,Cin,Cout] w, got "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")


# ---------------------------------------------------------------------------
# plain versions of K8, K9 and K10
# ---------------------------------------------------------------------------
def _conv_taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The sum of the nine shift-and-matmul taps of the zero-padded x,
    accumulated in float32: ``[B·H·W, Cout]``."""
    b, h, wd, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            win = xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, cin)
            t = torch.matmul(win.float(), w[dy, dx].float())
            acc = t if acc is None else acc + t
    return acc


def _nhwc(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return acc.to(x.dtype).reshape(*x.shape[:3], acc.shape[1])


def plain_conv3x3_bn_relu(x, w, scale, bias) -> torch.Tensor:
    """K8's plain version: ``acc · scale`` rounded, ``+ bias`` rounded,
    the max with 0, cast to x's dtype."""
    acc = _conv_taps(x, w)
    return _nhwc((acc * scale + bias).clamp_min(0), x)


def plain_conv3x3_stats(x, w):
    """K9's plain version: ``(y, Σ acc, Σ acc²)``, the sums over the
    float32 accumulator, not the rounded y."""
    acc = _conv_taps(x, w)
    return _nhwc(acc, x), acc.sum(dim=0), (acc * acc).sum(dim=0)


def plain_conv3x3_plain(x, w) -> torch.Tensor:
    """K10's plain version: the conv in x's dtype."""
    return _nhwc(_conv_taps(x, w), x)


# ---------------------------------------------------------------------------
# dispatch: the plain version for CPU tensors, the kernel for any other.
# K8-K10 are also the torch.library ops ``hvd::conv3x3_bn_relu``,
# ``hvd::conv3x3_stats`` and ``hvd::conv3x3_plain`` (CPU: the plain
# version, CUDA: the kernel, a fake and a FLOP formula), taken while a
# dispatch mode (make_fx, FlopCounterMode) is on.
# ---------------------------------------------------------------------------
_PLAIN = {"bn_relu": plain_conv3x3_bn_relu, "stats": plain_conv3x3_stats,
          "plain": plain_conv3x3_plain}
#: FLOPs per output element of each epilogue: K8 a multiply, an add and
#: a max; K9 the sum's add and the square's multiply and add
EPILOGUE_FLOPS = {"bn_relu": 3, "stats": 3, "plain": 0}

_LIB = torch.library.Library("hvd", "FRAGMENT")
_LIB.define("conv3x3_bn_relu(Tensor x, Tensor w, Tensor scale, "
            "Tensor bias) -> Tensor")
_LIB.define("conv3x3_stats(Tensor x, Tensor w) -> (Tensor, Tensor, Tensor)")
_LIB.define("conv3x3_plain(Tensor x, Tensor w) -> Tensor")


def _fake(kind: str):
    def fake(x, w, *epilogue):
        y = x.new_empty((*x.shape[:3], w.shape[3]))
        if kind != "stats":
            return y
        return (y, *(x.new_empty((w.shape[3],), dtype=torch.float32)
                     for _ in range(2)))
    return fake


def _flops(kind: str):
    def formula(x_shape, w_shape, *args, out_shape=None, **kw) -> int:
        outputs = math.prod(x_shape[:3]) * w_shape[3]
        return outputs * (2 * 9 * w_shape[2] + EPILOGUE_FLOPS[kind])
    return formula


for _kind, _plain in _PLAIN.items():
    _LIB.impl(f"conv3x3_{_kind}", _plain, "CPU")
    _LIB.impl(f"conv3x3_{_kind}", functools.partial(kernels.launch_conv3x3,
                                                    _kind), "CUDA")
    torch.library.register_fake(f"hvd::conv3x3_{_kind}", _fake(_kind),
                                lib=_LIB)
    register_flop_formula(getattr(torch.ops.hvd, f"conv3x3_{_kind}"))(
        _flops(_kind))


def _conv(kind: str, x, w, *epilogue):
    if _get_current_dispatch_mode() is None:
        if x.device.type == "cpu":
            return _PLAIN[kind](x, w, *epilogue)
        return kernels.launch_conv3x3(kind, x, w, *epilogue)
    return getattr(torch.ops.hvd, f"conv3x3_{kind}")(x, w, *epilogue)


def conv3x3_bn_relu(x, w, scale, bias) -> torch.Tensor:
    """``relu(conv3x3_same(x, w) · scale + bias)`` in one pass (K8).
    x: ``[B, H, W, Cin]`` NHWC; w: ``[3, 3, Cin, Cout]``; scale / bias:
    ``[Cout]`` float32, the folded BatchNorm affine (``scale =
    gamma·rsqrt(var + eps)``)."""
    _check(x, w)
    scale, bias = scale.float(), bias.float()
    with autocast_off(x):
        return _conv("bn_relu", x, w.contiguous(), scale.contiguous(),
                     bias.contiguous())


def conv3x3_stats(x, w):
    """``conv3x3_same(x, w)`` plus the per-channel sum and sum of squares
    of its float32 accumulator (K9).  Returns ``(y [B, H, W, Cout],
    sum [Cout] float32, sumsq [Cout] float32)``."""
    _check(x, w)
    with autocast_off(x):
        return _conv("stats", x, w.contiguous())


def conv3x3_plain(x, w) -> torch.Tensor:
    """``conv3x3_same(x, w)`` alone (K10): the transpose conv of the fused
    op's backward (a stride-1 SAME conv-transpose is the conv with the
    spatially flipped, io-transposed weights)."""
    _check(x, w)
    with autocast_off(x):
        return _conv("plain", x, w.contiguous())


# ---------------------------------------------------------------------------
# the training op: conv + batch statistics + BatchNorm + ReLU, with the full
# BatchNorm backward (gradients through mean and var, as flax's BatchNorm
# under autodiff)
# ---------------------------------------------------------------------------
class _ConvBNReluTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, gamma, beta, eps):
        y, s, sq = conv3x3_stats(x, w)
        n = x.shape[0] * x.shape[1] * x.shape[2]
        mean = s / n
        var = torch.clamp_min(sq / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        xhat = (y.float() - mean) * rstd
        out = torch.clamp_min(xhat * gamma + beta, 0.0).to(x.dtype)
        ctx.save_for_backward(x, w, y, mean, rstd, gamma, out)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g_out, _g_mean, _g_var):
        # mean and var feed the running averages under no_grad: their
        # cotangents are zero, as the reference's stop-gradient
        x, w, y, mean, rstd, gamma, out = ctx.saved_tensors
        with autocast_off(x):
            n = x.shape[0] * x.shape[1] * x.shape[2]
            g = torch.where(out.float() > 0, g_out.float(), 0.0)
            xhat = (y.float() - mean) * rstd
            dbeta = g.sum(dim=(0, 1, 2))
            dgamma = (g * xhat).sum(dim=(0, 1, 2))
            dy = (gamma * rstd) * (g - dbeta / n - xhat * (dgamma / n))
            # computed here, so made contiguous NHWC here for K10
            dy = dy.to(x.dtype).contiguous()
            wt = torch.flip(w, (0, 1)).permute(0, 1, 3, 2)  # [3,3,Cout,Cin]
            dx = conv3x3_plain(dy, wt)
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).shape,
                dy.permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
        return dx, dw.to(w.dtype), dgamma.to(gamma.dtype), \
            dbeta.to(gamma.dtype), None


def conv3x3_bn_relu_train(x, w, gamma, beta, eps: float = 1e-5):
    """Training forward: ``relu(BN(conv3x3_same(x, w)))`` with batch
    statistics, as one conv+stats pass (K9) plus an elementwise apply;
    the backward runs K10 for dx.  Returns ``(out, batch_mean,
    batch_var)``; the caller updates its running statistics from mean and
    var (no gradient flows through them)."""
    _check(x, w)
    with autocast_off(x):
        return _ConvBNReluTrain.apply(x, w, gamma, beta, float(eps))


# ---------------------------------------------------------------------------
# the reference's XLA twins, with PyTorch's convolution: the library
# yardstick (tests, chip_smoke.py), never on the training path
# ---------------------------------------------------------------------------
def _library_conv(x, w):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def torch_conv3x3_bn_relu(x, w, scale, bias) -> torch.Tensor:
    """``xla_conv3x3_bn_relu``: the library's conv in x's dtype, then the
    affine and relu in float32."""
    with autocast_off(x):
        y = _library_conv(x, w)
        return torch.clamp_min(y.float() * scale + bias, 0).to(x.dtype)


def torch_conv3x3_stats(x, w):
    """``xla_conv3x3_stats``: the library's conv and the sums of its
    (rounded) output."""
    with autocast_off(x):
        y = _library_conv(x, w)
        yf = y.float()
        return y, yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))
