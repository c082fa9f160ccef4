"""Gradient compression: the port of ``horovod_tpu/ops/compression.py``.

* :class:`NoneCompressor` / :class:`BF16Compressor` — the stateless cast
  pair (``fp16`` stays an alias of bf16, as the reference defines it).
* :class:`Int8Compressor` / :class:`FP8Compressor` (e4m3) /
  :class:`FP8E5M2Compressor` — per-tensor-scaled quantizers.  The scale
  is the *global* max |x|, a MAX all-reduce over the reducing group, so
  every rank dequantizes with the same factor; the quantized range is
  divided by the group's size so the int8 / fp8 *sum* cannot wrap or
  saturate.  The scale stays a device tensor (no ``.item()``), so a CUDA
  graph of the step recomputes it every replay.
* :class:`ErrorFeedback` — wraps a compressor; the residual arithmetic
  lives in ``fusion.fused_allreduce(..., residuals=)``.
* :class:`ErrorFeedbackGuard` and :func:`residual_norm` — the
  convergence guard the train step reads once a window.

The arithmetic keeps the reference's order, so ``q`` is bit-equal to it
on the CPU: ``x.float() / scale * headroom``, then for int8 round, clip
to ±headroom and the truncating cast, for fp8 the cast; decompression is
``(q.float() * factor).to(orig)``.

The wire dtypes each backend reduces: int8 SUM on NCCL and gloo; float8
SUM only on NCCL (2.24 and later, where torch maps the type), never on
gloo.  :func:`check_wire` raises, naming the backend, where a reduction
cannot take the wire dtype; nothing quietly sends float32 instead.

Integer, bool and complex tensors pass through every compressor
untouched.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

import numpy as np
import torch
import torch.distributed as dist

from .. import metrics
from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

#: the float8 wire dtypes
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)



def _compressible(tensor) -> bool:
    """Only real floating tensors are compressed; integer, bool and
    complex ones pass through (a cast would corrupt them)."""
    return tensor.is_floating_point()


def check_wire(dtype: torch.dtype, device: torch.device) -> None:
    """Raises when a SUM over the backend of ``device``'s tensors cannot
    take ``dtype``: gloo (the CPU's) reduces no float8 type, and NCCL
    only from 2.24 on.  The all-reduce itself raises for anything else
    the backend refuses."""
    if dtype not in FP8_DTYPES:
        return
    if device.type != "cuda":
        raise RuntimeError(
            f"gloo cannot reduce {dtype}: a float8 wire needs NCCL on a "
            "CUDA device (the CPU's tensors reduce over gloo); use int8 "
            "or bf16 compression there")
    version = torch.cuda.nccl.version()
    if tuple(version) < (2, 24):
        raise RuntimeError(
            f"NCCL {'.'.join(map(str, version))} cannot reduce {dtype}: "
            "float8 reductions need NCCL 2.24 or later")


def average_(total: torch.Tensor, group_size: int) -> torch.Tensor:
    """A group's sum over its size.  A float wire divides in its own
    type, in place, as the reference divides; an integer or float8 wire
    (the quantizers, integer leaves) is a SUM, then a float32 division
    (the reference's int8 ``psum / n`` promotes the same way) — never an
    averaging all-reduce, which NCCL truncates on integers and gloo
    lacks."""
    # divided by a device tensor: CUDA's division by a host scalar
    # multiplies by its reciprocal, a rounding away from the reference's
    # quotient when the size is not a power of two
    if total.is_floating_point() and total.dtype not in FP8_DTYPES:
        return total.div_(torch.full((), group_size, dtype=total.dtype,
                                     device=total.device))
    return total.float() / torch.full((), group_size, dtype=torch.float32,
                                      device=total.device)


def _reduce_max_(m: torch.Tensor, group=None) -> torch.Tensor:
    """``m`` (float32, on the device) MAX-reduced in place over ``group``
    when a process group exists; the local value otherwise."""
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    return m


def local_max_abs(tensors: List[torch.Tensor]) -> torch.Tensor:
    """Each tensor's max |x| in float32, stacked: ``[len(tensors)]`` on
    their device.  A max is one of the values, so it is exact in any
    type."""
    return torch.stack([t.detach().abs().amax().float() if t.numel()
                        else t.new_zeros((), dtype=torch.float32)
                        for t in tensors])


class Compressor:
    """Interface for compressing and decompressing a given tensor."""

    #: registry name (``Compression.lookup`` vocabulary)
    name = "none"
    #: wire bytes per element (None = unchanged)
    wire_itemsize: Optional[int] = None
    #: True when compress needs a cross-rank scale exchange
    scale_exchange = False

    @staticmethod
    def compress(tensor):
        """Returns ``(compressed_tensor, context)``."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError

    @classmethod
    def compress_for(cls, tensor, group_size: int, **_):
        """Compress for a reduction over ``group_size`` ranks; the casts
        ignore the group's size."""
        del group_size
        return cls.compress(tensor)


class NoneCompressor(Compressor):
    name = "none"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class BF16Compressor(Compressor):
    """Cast to bfloat16 for the collective, cast back after."""

    name = "bf16"
    wire_itemsize = 2

    @staticmethod
    def compress(tensor):
        if not _compressible(tensor):
            return tensor, None
        return tensor.to(torch.bfloat16), tensor.dtype

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tensor.to(ctx)
        return tensor


class _ScaledQuantizer(Compressor):
    """The scale and headroom arithmetic of the int8 / fp8 wire formats:
    ``q = quantize(x / scale * (max_mag / group_size))`` with ``scale =
    max(global max |x|, 1e-30)``, so every ``|q| <= max_mag /
    group_size`` and the group's sum stays in range.  ``ctx`` is
    ``(orig_dtype, scale / headroom)``, the factor a float32 device
    tensor."""

    max_mag = 1.0
    wire_dtype = torch.int8

    @classmethod
    def _quantize(cls, x_unit, headroom: float):
        raise NotImplementedError

    @classmethod
    def headroom(cls, group_size: int) -> float:
        return cls.max_mag / max(int(group_size), 1)

    @classmethod
    def keeps_levels(cls, group_size: int) -> bool:
        """Whether at least two quantization levels survive the
        headroom of ``group_size`` ranks (int8 up to 63 ranks, e4m3 up
        to 224); below that the tensor ships uncompressed."""
        return cls.headroom(group_size) >= 2.0

    @classmethod
    def compress_for(cls, tensor, group_size: int, *, group=None,
                     max_abs: Optional[torch.Tensor] = None):
        """``max_abs``: the global max |x| when the caller reduced it
        already (the fusion layer reduces every tensor's in one
        all-reduce); else one MAX all-reduce over ``group``."""
        if not _compressible(tensor):
            return tensor, None
        headroom = cls.headroom(group_size)
        if headroom < 2.0:
            # counted on the host as the calls are issued, in the
            # counter of the guard's trips (training.py counts those)
            if metrics.on():
                metrics.COMPRESSION_FALLBACKS.inc()
            log.warning(
                "%s over a %d-rank group leaves %.2f quantization levels — "
                "shipping uncompressed (use two-level reduction to "
                "compress across hosts instead)", cls.name, group_size,
                headroom)
            return tensor, None
        if max_abs is None:
            max_abs = _reduce_max_(local_max_abs([tensor]), group)[0]
        scale = torch.clamp_min(max_abs.float(), 1e-30)
        q = cls._quantize(tensor.float() / scale, headroom)
        # the factor divided by a device tensor, as average_ divides
        return q, (tensor.dtype, scale / torch.full_like(scale, headroom))

    @classmethod
    def compress(cls, tensor):
        # the single-rank entry: no summation headroom
        return cls.compress_for(tensor, 1)

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is None:
            return tensor
        orig_dtype, factor = ctx
        return (tensor.float() * factor).to(orig_dtype)


class Int8Compressor(_ScaledQuantizer):
    """Per-tensor-scaled symmetric int8 (round half to even, clipped)."""

    name = "int8"
    wire_itemsize = 1
    scale_exchange = True
    max_mag = 127.0
    wire_dtype = torch.int8

    @classmethod
    def _quantize(cls, x_unit, headroom: float):
        # clipped to the headroom, not max_mag: round(±headroom) can land
        # a step above it, and the truncating cast then keeps every |q|
        # <= floor(headroom), so the group's sum cannot wrap
        q = torch.clamp(torch.round(x_unit * headroom), -headroom, headroom)
        return q.to(torch.int8)


class FP8Compressor(_ScaledQuantizer):
    """Per-tensor-scaled float8 e4m3 (448 max, 3 mantissa bits)."""

    name = "fp8_e4m3"
    wire_itemsize = 1
    scale_exchange = True
    max_mag = 448.0
    wire_dtype = torch.float8_e4m3fn

    @classmethod
    def _quantize(cls, x_unit, headroom: float):
        return (x_unit * headroom).to(cls.wire_dtype)


class FP8E5M2Compressor(FP8Compressor):
    """float8 e5m2: wider range (57344 max), 2 mantissa bits."""

    name = "fp8_e5m2"
    max_mag = 57344.0
    wire_dtype = torch.float8_e5m2


def inner(comp):
    """The compressor an :class:`ErrorFeedback` wraps, or ``comp``."""
    return getattr(comp, "compressor", comp)


def is_scaled(comp) -> bool:
    """Whether ``comp`` (a compressor, or one wrapped in
    :class:`ErrorFeedback`) quantizes with a global scale."""
    comp = inner(comp)
    return isinstance(comp, type) and issubclass(comp, _ScaledQuantizer)


def compress_with(comp, tensor, group_size: int, *, group=None,
                  max_abs: Optional[torch.Tensor] = None):
    """One compressor call for a reduction over ``group_size`` ranks: a
    scaled quantizer's ``compress_for`` with the group its scale is
    reduced over (or the global max |x| already reduced), any other
    compressor's ``compress_for``, or ``compress`` for a compressor of
    the older two-method interface."""
    if is_scaled(comp):
        return comp.compress_for(tensor, group_size, group=group,
                                 max_abs=max_abs)
    fn = getattr(comp, "compress_for", None)
    if fn is not None:
        return fn(tensor, group_size)
    return comp.compress(tensor)


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------
class ErrorFeedback:
    """Carry the quantization residual across steps: each step reduces
    ``grad + residual`` and keeps ``residual' = (grad + residual) -
    decompress(compress(grad + residual))``
    (``fusion.fused_allreduce(..., residuals=)``).  Stateless calls go to
    the wrapped compressor; :meth:`init_state` builds the zero residual.
    Wrapping :class:`NoneCompressor` is valid (the residual stays 0)."""

    stateful = True

    def __init__(self, compressor: Optional[Type[Compressor]] = None):
        self.compressor = compressor if compressor is not None \
            else Int8Compressor

    @property
    def name(self) -> str:
        return f"ef_{self.compressor.name}"

    @property
    def wire_itemsize(self):
        return self.compressor.wire_itemsize

    @property
    def scale_exchange(self):
        return self.compressor.scale_exchange

    def compress(self, tensor):
        return self.compressor.compress(tensor)

    def compress_for(self, tensor, group_size: int, **kw):
        return self.compressor.compress_for(tensor, group_size, **kw)

    def decompress(self, tensor, ctx):
        return self.compressor.decompress(tensor, ctx)

    def __repr__(self):
        return f"ErrorFeedback({self.compressor.__name__})"

    @staticmethod
    def init_state(tree):
        """A zero residual shaped like ``tree`` (a dict of tensors)."""
        from ..utils.tree import tree_flatten, tree_unflatten

        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [torch.zeros_like(t.detach())
                                        for t in leaves])


class ErrorFeedbackGuard:
    """The residual norm of a healthy error-feedback loop stays near its
    early level; one past ``factor`` times the median of the first
    ``warmup`` samples, or not finite, means the loop diverges and the
    step must fall back to uncompressed reduction.  Host float logic,
    the same on every rank that sees the same norms."""

    def __init__(self, factor: Optional[float] = None, warmup: int = 3):
        self.factor = factor if factor is not None else env_util.get_float(
            env_util.HVD_COMPRESSION_GUARD_FACTOR,
            env_util.DEFAULT_COMPRESSION_GUARD_FACTOR)
        self.warmup = max(int(warmup), 1)
        self._early: List[float] = []
        self.baseline: Optional[float] = None

    def observe(self, norm: float) -> bool:
        """Feed one residual-norm sample; True = diverged (fall back)."""
        norm = float(norm)
        if not np.isfinite(norm):
            return True
        if self.baseline is None:
            self._early.append(norm)
            if len(self._early) < self.warmup:
                return False
            self.baseline = float(np.median(self._early))
            return False
        return norm > self.factor * max(self.baseline, 1e-30)


def _sq_norm(leaves) -> torch.Tensor:
    """Σ x·x over the leaves, in float32, leaf after leaf."""
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        x = leaf.detach().float().reshape(-1)
        total = total + torch.dot(x, x)
    return total


def residual_norm(residual) -> float:
    """Global L2 norm of a residual tree (float leaves only): one
    reduction on the device and one read to the host."""
    from ..utils.tree import tree_flatten

    leaves = [t for t in tree_flatten(residual)[0] if _compressible(t)]
    if not leaves:
        return 0.0
    return float(np.sqrt(max(float(_sq_norm(leaves).item()), 0.0)))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Type[Compressor]] = {
    "none": NoneCompressor,
    "fp16": BF16Compressor,   # the reference's alias: bf16 is its half type
    "bf16": BF16Compressor,
    "int8": Int8Compressor,
    "fp8": FP8Compressor,
    "fp8_e4m3": FP8Compressor,
    "fp8_e5m2": FP8E5M2Compressor,
}


class Compression:
    """The wire formats: attributes for the built-ins, :meth:`lookup` for
    knob and plan strings, :meth:`register` for custom ones."""

    none = NoneCompressor
    fp16 = BF16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = FP8Compressor
    fp8_e4m3 = FP8Compressor
    fp8_e5m2 = FP8E5M2Compressor

    @staticmethod
    def names() -> List[str]:
        return sorted(_REGISTRY)

    @staticmethod
    def lookup(name: Optional[str], error_feedback: bool = False):
        """A compressor by registry name (None/'' → none);
        ``error_feedback`` (or an ``ef_`` prefix) wraps it in
        :class:`ErrorFeedback`, a no-op for ``none``."""
        key = str(name).strip().lower() if name else "none"
        if key.startswith("ef_"):
            key, error_feedback = key[3:], True
        try:
            comp = _REGISTRY[key]
        except KeyError:
            raise ValueError(
                f"unknown compression {name!r}; registered: "
                f"{', '.join(Compression.names())}") from None
        if error_feedback and comp is not NoneCompressor:
            return ErrorFeedback(comp)
        return comp

    @staticmethod
    def register(name: str, compressor: Type[Compressor]) -> None:
        _REGISTRY[str(name).strip().lower()] = compressor


def from_env():
    """The job's choice: ``HVD_COMPRESSION`` (none | bf16 | int8 | fp8 |
    fp8_e5m2), error-feedback-wrapped unless
    ``HVD_COMPRESSION_ERROR_FEEDBACK=0``."""
    name = env_util.get_str(env_util.HVD_COMPRESSION, "none")
    ef = env_util.get_bool(env_util.HVD_COMPRESSION_ERROR_FEEDBACK, True)
    return Compression.lookup(name, error_feedback=ef)
