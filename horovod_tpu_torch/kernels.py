"""Build and bind the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no
PyTorch header.  On first use they are compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together, then one
link) into ``build/horovod_tpu_torch/libhvd_torch_kernels.so`` inside
the checkout, and rebuilt whenever a source is newer than the library.
The library is loaded with ``ctypes``; launches take raw device pointers
and the caller's current CUDA stream.

Nothing here runs at import: the CPU tests import this module on a
machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import fcntl
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "horovod_tpu_torch"
LIB_PATH = BUILD_DIR / "libhvd_torch_kernels.so"

#: Hopper with its architecture-specific features; --fmad=false keeps
#: every multiply and add rounded separately, as the plain versions round
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

#: the parameter-group types K1 takes, as its launch counts name them
K1_DTYPES = ("float32", "bfloat16")
#: launches of K1 per update rule and group type (``"momentum.float32"``,
#: ...), counted where the kernel is launched; :func:`launch_totals` sums
#: them per rule
fused_update_launches: Dict[str, int] = {
    f"{r}.{d}": 0 for r in ("sgd", "momentum", "adam") for d in K1_DTYPES}
#: the mainloops of K2-K4 (see :func:`flash_plan`)
FLASH_MAINLOOPS = ("wgmma", "mma_sync", "f32")
#: the flash kernels by launch kind: K2 (fwd), K3 (bwd_dq), K4 (bwd_dkv)
FLASH_KINDS = ("fwd", "bwd_dq", "bwd_dkv")
#: launches of K2-K4 per kind and mainloop (``"fwd.wgmma"``,
#: ``"bwd_dq.mma_sync"``, ...), counted likewise; :func:`launch_totals`
#: sums them per kind
flash_launches: Dict[str, int] = {
    f"{k}.{m}": 0 for k in FLASH_KINDS for m in FLASH_MAINLOOPS}

#: launches of K6 (scale_bias_relu), its backward (scale_bias_relu_bwd:
#: the pass and its second pass), K6' (relu_grad) and K7 (residual_relu),
#: counted likewise
elementwise_launches: Dict[str, int] = {
    "scale_bias_relu": 0, "scale_bias_relu_bwd": 0, "relu_grad": 0,
    "residual_relu": 0}
#: the mainloops of K8-K10 (see :func:`conv3x3_plan`)
CONV_MAINLOOPS = ("wgmma", "mma_sync", "f32")
#: launches of K8 (bn_relu), K9 (stats) and K10 (plain) per mainloop
#: (``"stats.wgmma"``, ...), counted likewise
conv_bn_launches: Dict[str, int] = {
    f"{k}.{m}": 0 for k in ("bn_relu", "stats", "plain")
    for m in CONV_MAINLOOPS}

#: every launch counter above.  A wrapper counts the launches it issues;
#: a CUDA graph's replay runs the kernels it captured without them
LAUNCH_COUNTERS = (fused_update_launches, flash_launches,
                   elementwise_launches, conv_bn_launches)

#: head dims with a template instance in csrc/flash_attention.cu (the
#: mma.sync and float32 kernels)
FLASH_HEAD_DIMS = (16, 32, 64, 128)
#: head dims of the TMA + wgmma kernels: one 128-byte swizzled row
FLASH_WGMMA_HEAD_DIMS = (64,)
#: HvdFlashArgs.mainloop of the two bfloat16 mainloops
_FLASH_BF16_MAINLOOPS = {"mma_sync": 0, "wgmma": 1}
#: the types K1-K4 and K6-K10 have instances for, as their C code numbers
#: them
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: HvdConvArgs.epilogue of K10, K9 and K8
_CONV_EPILOGUES = {"plain": 0, "stats": 1, "bn_relu": 2}
#: HvdConvArgs.mainloop of the two bfloat16 mainloops
_CONV_BF16_MAINLOOPS = {"mma_sync": 0, "wgmma": 1}
#: tiles for each block the card holds at once from which a TMA + wgmma
#: launch is persistent (see conv3x3_plan)
WGMMA_PERSIST_WAVES = 4

_lib: Optional[ctypes.CDLL] = None


def launch_totals(counts: Dict[str, int]) -> Dict[str, int]:
    """A launch counter keyed ``"kernel.variant"`` summed per kernel."""
    totals: Dict[str, int] = {}
    for key, n in counts.items():
        kernel = key.split(".")[0]
        totals[kernel] = totals.get(kernel, 0) + n
    return totals


class _Bhsd(ctypes.Structure):
    """``HvdBhsd``: a [b, h, s, d] operand as pointer and strides."""
    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_int64),
                ("sh", ctypes.c_int64), ("ss", ctypes.c_int64)]


class _FlashArgs(ctypes.Structure):
    """``HvdFlashArgs`` of csrc/flash_attention.cu, field for field."""
    _fields_ = ([(n, _Bhsd) for n in ("q", "k", "v", "o", "dout", "dq",
                                      "dk", "dv")]
                + [(n, ctypes.c_void_p) for n in ("m", "l", "lse", "delta")]
                + [(n, ctypes.c_int64) for n in ("b", "h", "sq", "sk", "d",
                                                 "q_off", "kv_off")]
                + [("scale", ctypes.c_float)]
                + [(n, ctypes.c_int32) for n in ("causal", "normalize",
                                                 "dtype", "mainloop")])


class _ConvArgs(ctypes.Structure):
    """``HvdConvArgs`` of csrc/conv_bn.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "w", "y", "scale",
                                                "bias", "partial", "sum",
                                                "sumsq")]
                + [(n, ctypes.c_int64) for n in ("b", "h", "wd", "cin",
                                                 "cout", "tiles")]
                + [(n, ctypes.c_int32) for n in ("epilogue", "dtype",
                                                 "mainloop", "tile_n",
                                                 "blocks")])


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile and link the library if it is missing or stale (or
    ``force``); returns nvcc's output.  ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        # several ranks on one host may start together: one builds
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not _stale():
            return ""
        nvcc = _nvcc()
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = []
        objects = []
        for src in sources():
            obj = BUILD_DIR / (src.stem + ".o")
            objects.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "\n".join(log))
        tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *[str(o) for o in objects],
             "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking {LIB_PATH.name} failed:\n"
                               f"{link.stdout}")
        os.replace(tmp, LIB_PATH)
        return "\n".join(log) + link.stdout


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    i32 = ctypes.c_int32
    lib.hvd_sgd.argtypes = [ptr, ptr, i64, f32, i32, ptr]
    lib.hvd_momentum.argtypes = [ptr, ptr, ptr, i64, f32, f32, i32, ptr]
    lib.hvd_adam.argtypes = [ptr, ptr, ptr, ptr, i64] + [f32] * 6 + [
        ptr, i32, ptr]
    flash = (lib.hvd_flash_fwd, lib.hvd_flash_bwd_dq, lib.hvd_flash_bwd_dkv)
    for fn in flash:
        fn.argtypes = [ctypes.POINTER(_FlashArgs), ptr]
    lib.hvd_residual_relu.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.hvd_relu_grad.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.hvd_scale_bias_relu.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32,
                                        i32, ptr]
    lib.hvd_scale_bias_relu_bwd.argtypes = [ptr] * 8 + [i64, i64] + [
        i32] * 3 + [ptr]
    lib.hvd_conv3x3.argtypes = [ctypes.POINTER(_ConvArgs), ptr]
    lib.hvd_conv3x3_wgmma_occupancy.argtypes = [i32,
                                                ctypes.POINTER(i32)]
    for fn in (lib.hvd_sgd, lib.hvd_momentum, lib.hvd_adam,
               *flash, lib.hvd_residual_relu, lib.hvd_relu_grad,
               lib.hvd_scale_bias_relu, lib.hvd_scale_bias_relu_bwd,
               lib.hvd_conv3x3,
               lib.hvd_conv3x3_wgmma_occupancy):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check_on_card(what: str, tensors: List[torch.Tensor]) -> None:
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(
                f"{what} take CUDA tensors on one device, got {t.device} "
                f"beside {first.device}")


def _check(tensors: List[torch.Tensor]) -> None:
    first = tensors[0]
    _check_on_card("K1", tensors)
    for t in tensors:
        if t.dtype not in _DTYPES or t.dtype != first.dtype:
            raise TypeError(
                "K1 takes float32 or bfloat16 buffers of one dtype, got "
                f"{[t.dtype for t in tensors]}")
        if not t.is_contiguous():
            raise ValueError("K1 takes contiguous flat buffers")
        if t.numel() != first.numel():
            raise ValueError(
                f"K1 buffers differ in length: {t.numel()} vs "
                f"{first.numel()}")


def _launch(fn_name: str, counts: Dict[str, int], key: str,
            device: torch.device, *args) -> None:
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    counts[key] += 1


def launch_fused_update(kind: str, p: torch.Tensor, g: torch.Tensor,
                        mu: Optional[torch.Tensor] = None,
                        nu: Optional[torch.Tensor] = None, *, lr: float,
                        momentum: float = 0.0, b1: float = 0.0,
                        b2: float = 0.0, eps: float = 0.0,
                        one_minus_b1: float = 0.0, one_minus_b2: float = 0.0,
                        bc: Optional[torch.Tensor] = None) -> None:
    """Launch K1's ``kind`` rule in place over flat CUDA buffers of one
    dtype group (float32 or bfloat16) on the current stream.  Adam reads
    its bias corrections from ``bc``, a float32 ``[inv_bc1, inv_bc2]`` on
    the same card, when the kernel runs.  Raises on anything the kernel
    does not take and on a launch the CUDA runtime refuses."""
    bufs = {"sgd": [p, g], "momentum": [p, g, mu], "adam": [p, g, mu, nu]}
    if kind not in bufs:
        raise ValueError(f"unknown fused update rule {kind!r}")
    if any(t is None for t in bufs[kind]):
        raise ValueError(f"the {kind} rule needs its moment buffers")
    _check(bufs[kind])
    if kind == "adam":
        if bc is None or bc.dtype != torch.float32 or bc.shape != (2,) or \
                not bc.is_contiguous():
            raise ValueError("K1 adam takes its bias corrections as a "
                             "contiguous float32 [2] buffer")
        _check_on_card("K1", [p, bc])
    n = p.numel()
    if n == 0:
        return
    ptrs = [t.data_ptr() for t in bufs[kind]]
    args = {"sgd": (n, lr), "momentum": (n, lr, momentum),
            "adam": (n, lr, b1, b2, eps, one_minus_b1, one_minus_b2,
                     bc.data_ptr() if bc is not None else None)}[kind]
    _launch(f"hvd_{kind}", fused_update_launches,
            f"{kind}.{str(p.dtype).split('.')[-1]}", p.device, *ptrs, *args,
            _DTYPES[p.dtype])


def _bhsd(t: Optional[torch.Tensor]) -> _Bhsd:
    if t is None:
        return _Bhsd()
    return _Bhsd(t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: Optional[torch.Tensor] = None,
                 stats: Tuple[torch.Tensor, ...] = ()) -> None:
    """Raises on anything K2-K4 do not take: device, dtype, shape, head
    dim, strides."""
    ops = [q, k, v] + ([do] if do is not None else [])
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ops):
        raise TypeError("K2-K4 take float32 or bfloat16 q, k, v (and do) "
                        f"of one dtype, got {[t.dtype for t in ops]}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            (q.shape[0], q.shape[1], q.shape[3]) != \
            (k.shape[0], k.shape[1], k.shape[3]):
        raise ValueError(f"K2-K4 take [b, h, s, d] q and k/v that agree in "
                         f"b, h and d, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} is not q's {tuple(q.shape)}")
    if q.shape[3] not in FLASH_HEAD_DIMS:
        raise ValueError(f"K2-K4 have no instance for head dim {q.shape[3]}"
                         f" (they take {FLASH_HEAD_DIMS})")
    if any(t.stride(3) != 1 for t in ops):
        raise ValueError("K2-K4 take operands whose head dim is contiguous "
                         f"(strides {[t.stride() for t in ops]})")
    b, h, sq, _ = q.shape
    for t in stats:
        if t.dtype != torch.float32 or t.shape != (b, h, sq, 1) or \
                not t.is_contiguous():
            raise ValueError("K3/K4 take lse and delta as contiguous "
                             f"float32 [b, h, sq, 1], got {t.dtype} "
                             f"{tuple(t.shape)}")
    _check_on_card("K2-K4", ops + list(stats))


class FlashPlan(NamedTuple):
    """How K2-K4 run one launch: the mainloop (``"wgmma"``,
    ``"mma_sync"`` or ``"f32"``) and its tiles, the rows of q and of k/v a
    block takes at a time (K2's online softmax rounds p per kv tile, so
    the plain forward is compared with it at ``kv_tile``)."""

    mainloop: str
    q_tile: int
    kv_tile: int


def flash_plan(kind: str, dtype: torch.dtype, head_dim: int,
               lengths: Tuple[int, int],
               operands: Sequence[Tuple[int, Tuple[int, int, int]]],
               mainloop: Optional[str] = None) -> FlashPlan:
    """The dispatch rule of K2-K4 (csrc/flash_attention.cu's header) for
    one launch of ``kind`` (``"fwd"``, ``"bwd_dq"`` or ``"bwd_dkv"``) on
    operands of ``dtype`` and ``head_dim``, ``lengths`` (sq, sk), and the
    ``(data_ptr, (stride_b, stride_h, stride_s))`` of each operand the
    kernel copies (q, k, v and, for the backward, do), strides in
    elements:

    * bfloat16, head dim 64, both lengths nonzero, every operand on a
      16-byte boundary with every stride but the head dim's a positive
      multiple of 16 bytes (what TMA can address): the TMA + ``wgmma``
      mainloop, K2 on 128-row q tiles and 128-key kv tiles, K3 on 128-row
      q tiles and 64-key kv tiles, K4 on 128-key kv tiles and 64-row q
      tiles;
    * any other bfloat16 operands: ``mma_sync``, 64 x 64;
    * float32: the scalar kernels, 64 x 64.

    ``mainloop="mma_sync"`` asks for that mainloop on bfloat16 operands
    instead (``chip_smoke.py`` times the two side by side); nothing else
    may be asked for."""
    if kind not in FLASH_KINDS:
        raise ValueError(f"unknown flash kernel {kind!r}")
    if dtype not in _DTYPES:
        raise TypeError(f"K2-K4 take float32 or bfloat16, got {dtype}")
    if mainloop is not None and (mainloop != "mma_sync" or
                                 dtype != torch.bfloat16):
        raise ValueError(f"K2-K4 take mainloop='mma_sync' on bfloat16 "
                         f"alone, got {mainloop!r} on {dtype}")
    if dtype == torch.float32:
        return FlashPlan("f32", 64, 64)
    tma = all(ptr % 16 == 0 and all(st > 0 and st * 2 % 16 == 0
                                    for st in strides)
              for ptr, strides in operands)
    if mainloop is None and head_dim in FLASH_WGMMA_HEAD_DIMS and \
            min(lengths) > 0 and tma:
        return {"fwd": FlashPlan("wgmma", 128, 128),
                "bwd_dq": FlashPlan("wgmma", 128, 64),
                "bwd_dkv": FlashPlan("wgmma", 64, 128)}[kind]
    return FlashPlan("mma_sync", 64, 64)


def flash_plan_for(kind: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, do: Optional[torch.Tensor] = None,
                   mainloop: Optional[str] = None) -> FlashPlan:
    """:func:`flash_plan` for [b, h, s, d] operands as the wrappers pass
    them (``do`` for the backward)."""
    ops = [q, k, v] + ([do] if do is not None else [])
    return flash_plan(kind, q.dtype, q.shape[-1], (q.shape[2], k.shape[2]),
                      [(t.data_ptr(), tuple(t.stride()[:3])) for t in ops],
                      mainloop)


def _flash_args(q, k, v, plan: FlashPlan, *, causal: bool, scale: float,
                q_offset: int, kv_offset: int, normalize: bool = True,
                **operands) -> _FlashArgs:
    b, h, sq, d = q.shape
    a = _FlashArgs(q=_bhsd(q), k=_bhsd(k), v=_bhsd(v), b=b, h=h, sq=sq,
                   sk=k.shape[2], d=d, q_off=int(q_offset),
                   kv_off=int(kv_offset), scale=float(scale),
                   causal=int(bool(causal)), normalize=int(bool(normalize)),
                   dtype=_DTYPES[q.dtype],
                   mainloop=_FLASH_BF16_MAINLOOPS.get(plan.mainloop, 0))
    for name, t in operands.items():
        if name in ("m", "l", "lse", "delta"):
            setattr(a, name, t.data_ptr())
        else:
            setattr(a, name, _bhsd(t))
    return a


def launch_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, scale: float, q_offset: int = 0,
                     kv_offset: int = 0, normalize: bool = True,
                     mainloop: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on [b, h, s, d] CUDA tensors: ``(o, m, l)``, o in q's dtype
    (``normalize``) or float32, m and l float32 ``[b, h, sq, 1]``.  The
    mainloop is :func:`flash_plan`'s (``mainloop="mma_sync"``: that one
    on bfloat16)."""
    _check_flash(q, k, v)
    plan = flash_plan_for("fwd", q, k, v, mainloop=mainloop)
    b, h, sq, _ = q.shape
    o = torch.empty_like(q, dtype=q.dtype if normalize else torch.float32)
    m = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    args = _flash_args(q, k, v, plan, causal=causal, scale=scale,
                       q_offset=q_offset, kv_offset=kv_offset,
                       normalize=normalize, o=o, m=m, l=l)
    _launch("hvd_flash_fwd", flash_launches, f"fwd.{plan.mainloop}",
            q.device, ctypes.byref(args))
    return o, m, l


def launch_flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                        scale: float, q_offset: int = 0, kv_offset: int = 0,
                        mainloop: Optional[str] = None) -> torch.Tensor:
    """K3: dq in float32, laid out like q; the mainloop as for
    :func:`launch_flash_fwd`."""
    _check_flash(q, k, v, do, (lse, delta))
    plan = flash_plan_for("bwd_dq", q, k, v, do, mainloop=mainloop)
    dq = torch.empty_like(q, dtype=torch.float32)
    args = _flash_args(q, k, v, plan, causal=causal, scale=scale,
                       q_offset=q_offset, kv_offset=kv_offset, dout=do,
                       lse=lse, delta=delta, dq=dq)
    _launch("hvd_flash_bwd_dq", flash_launches, f"bwd_dq.{plan.mainloop}",
            q.device, ctypes.byref(args))
    return dq


def launch_flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                         scale: float, q_offset: int = 0, kv_offset: int = 0,
                         mainloop: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(dk, dv)`` in float32, laid out like k and v; the mainloop as
    for :func:`launch_flash_fwd`."""
    _check_flash(q, k, v, do, (lse, delta))
    plan = flash_plan_for("bwd_dkv", q, k, v, do, mainloop=mainloop)
    dk = torch.empty_like(k, dtype=torch.float32)
    dv = torch.empty_like(v, dtype=torch.float32)
    args = _flash_args(q, k, v, plan, causal=causal, scale=scale,
                       q_offset=q_offset, kv_offset=kv_offset, dout=do,
                       lse=lse, delta=delta, dk=dk, dv=dv)
    _launch("hvd_flash_bwd_dkv", flash_launches, f"bwd_dkv.{plan.mainloop}",
            q.device, ctypes.byref(args))
    return dk, dv


def _check_elementwise(x: torch.Tensor, *others: torch.Tensor) -> None:
    """Raises on anything K6, its backward, K6' and K7 do not take:
    device, dtype, shape, layout."""
    ops = [x, *others]
    _check_on_card("K6-K7", ops)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in others):
        raise TypeError("K6-K7 take float32 or bfloat16 operands of one "
                        f"dtype, got {[t.dtype for t in ops]}")
    if any(t.shape != x.shape for t in others):
        raise ValueError(f"K6-K7 operands differ in shape: "
                         f"{[tuple(t.shape) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("K6-K7 take contiguous channels-last operands "
                         f"(C innermost), got strides "
                         f"{[t.stride() for t in ops]}")


def _check_channels(what: str, x: torch.Tensor,
                    *vectors: torch.Tensor) -> int:
    """Raises unless each of ``vectors`` is a contiguous float32 ``[C]``
    on x's card, C x's last dim; returns C."""
    _check_on_card(what, [x, *vectors])
    c = x.shape[-1] if x.dim() else 0
    for t in vectors:
        if t.dtype != torch.float32 or t.shape != (c,) or \
                not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous float32 scale and "
                             f"bias [{c}], got {t.dtype} {tuple(t.shape)}")
    return c


#: the blocks csrc/elementwise.cu launches (its kJoin*, kBwd* and
#: kBwdGeneralThreads), as the plan needs them: threads, and 16-byte packs
#: a thread.  K6 and K7: a sweep over ResNet-50's join shapes at batch 128,
#: 32 and 1 (scripts/elementwise_sweep.py, PERF.md section 6) found no
#: block of 128-512 threads x 1-4 packs more than ~2% faster at any of
#: them, and this one the fastest summed over each batch's joins
EW_THREADS, EW_PACKS = 128, 2
#: K6's backward on the channel loop: its block, and its blocks G, at most
#: EW_BWD_BLOCKS_PER_SM an SM and at most one a round (the same sweep)
EW_BWD_THREADS, EW_BWD_PACKS = 256, 4
EW_BWD_BLOCKS_PER_SM = 2
#: the general route of K6's backward: its block, and rows a block at
#: least
EW_BWD_GENERAL_THREADS = 128
EW_BWD_GENERAL_ROWS = 64


class ElementwisePlan(NamedTuple):
    """How K6, its backward or K7 runs one launch: the loop
    (``"channel"``, ``"stream"``, ``"flat_binary"`` or ``"general"``) and
    the blocks of K6's backward, which size its scratch (``[2, blocks,
    C]``); 0 where the loop's grid follows from the size."""

    loop: str
    blocks: int


def elementwise_plan(kind: str, dtype: torch.dtype, shape: Tuple[int, ...],
                     ptrs: Sequence[int], sms: int,
                     loop: Optional[str] = None) -> ElementwisePlan:
    """The dispatch rule of K7 (``kind="residual_relu"``), K6
    (``"scale_bias_relu"``) and K6's backward (``"scale_bias_relu_bwd"``)
    (csrc/elementwise.cu's header) for channels-last operands of
    ``dtype`` and ``shape`` at addresses ``ptrs`` (every operand the
    kernel reads or writes 16 bytes at a time: scale and bias too), on a
    card of ``sms`` SMs.  A pack is 16 bytes: 8 bf16 or 4 float32.

    * K7: the stream loop (with an operand misaligned, the loop's scalar
      path).
    * K6: the channel loop when C is a multiple of the pack, every operand
      is 16-byte aligned and a block of :data:`EW_THREADS` is a whole
      number of rows of packs (every ResNet ``BatchNormReLU``: C =
      64-512); else flat_binary, the loop it ran before.
    * K6's backward: under K6's condition at :data:`EW_BWD_THREADS`, the
      channel loop on min(sms x :data:`EW_BWD_BLOCKS_PER_SM`, rounds of
      :data:`EW_BWD_THREADS` x :data:`EW_BWD_PACKS` packs) blocks; else
      the general route, on min(sms x :data:`EW_BWD_BLOCKS_PER_SM`, rows /
      :data:`EW_BWD_GENERAL_ROWS`) blocks.  Either depends on the shape
      and the card alone, so the sums' order does too.

    ``loop="flat_binary"`` asks K6 or K7 for their old loop instead
    (``chip_smoke.py`` times the two side by side); nothing else may be
    asked for."""
    if kind not in ("residual_relu", "scale_bias_relu",
                    "scale_bias_relu_bwd"):
        raise ValueError(f"unknown elementwise kernel {kind!r}")
    if dtype not in _DTYPES:
        raise TypeError(f"K6-K7 take float32 or bfloat16, got {dtype}")
    if loop is not None and (loop != "flat_binary" or
                             kind == "scale_bias_relu_bwd"):
        raise ValueError(f"{kind} has no loop {loop!r}: its plan's (None) "
                         "or, for K6 and K7, 'flat_binary'")
    pack = 16 // (4 if dtype == torch.float32 else 2)
    n = math.prod(shape)
    c = shape[-1] if shape else 1
    aligned = all(p % 16 == 0 for p in ptrs)
    if loop == "flat_binary":
        return ElementwisePlan("flat_binary", 0)
    if kind == "residual_relu":
        return ElementwisePlan("stream", 0)
    threads = EW_THREADS if kind == "scale_bias_relu" else EW_BWD_THREADS
    channel = aligned and c and c % pack == 0 and threads % (c // pack) == 0
    if kind == "scale_bias_relu":
        return ElementwisePlan("channel" if channel else "flat_binary", 0)
    cap = sms * EW_BWD_BLOCKS_PER_SM
    if channel:
        rounds = -(-(n // pack) // (EW_BWD_THREADS * EW_BWD_PACKS))
        return ElementwisePlan("channel", min(cap, rounds))
    rows = n // c if c else 0
    return ElementwisePlan("general",
                           max(1, min(cap, rows // EW_BWD_GENERAL_ROWS)))


@functools.lru_cache(maxsize=None)
def card_sms(index: int) -> int:
    """The SMs of CUDA card ``index``, asked once per card."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ew_plan(kind: str, x: torch.Tensor, ptrs: Sequence[int],
             loop: Optional[str] = None) -> ElementwisePlan:
    return elementwise_plan(kind, x.dtype, tuple(x.shape), ptrs,
                            card_sms(x.device.index), loop)


def launch_residual_relu(x: torch.Tensor, y: torch.Tensor, *,
                         loop: Optional[str] = None) -> torch.Tensor:
    """K7: ``relu(x + y)`` in x's dtype, laid out like x, on the stream
    loop; ``loop="flat_binary"`` asks for the one-pack loop it ran before,
    kept to be timed beside it."""
    _check_elementwise(x, y)
    out = torch.empty_like(x)
    if x.numel():
        ptrs = (x.data_ptr(), y.data_ptr(), out.data_ptr())
        p = _ew_plan("residual_relu", x, ptrs, loop)
        _launch("hvd_residual_relu", elementwise_launches, "residual_relu",
                x.device, *ptrs, x.numel(), _DTYPES[x.dtype],
                int(p.loop == "flat_binary"))
    return out


def launch_relu_grad(out: torch.Tensor, g: torch.Tensor, *,
                     loop: Optional[str] = None) -> torch.Tensor:
    """K6': ``where(out > 0, g, 0)``, laid out like out, on its own loop;
    ``loop="flat_binary"`` asks for the one-pack loop it ran before, kept
    to be timed beside it."""
    if loop not in (None, "flat_binary"):
        raise ValueError(f"K6' has no loop {loop!r}: its own (None) or "
                         f"'flat_binary'")
    _check_elementwise(out, g)
    dx = torch.empty_like(g)
    if g.numel():
        _launch("hvd_relu_grad", elementwise_launches, "relu_grad",
                g.device, out.data_ptr(), g.data_ptr(), dx.data_ptr(),
                g.numel(), _DTYPES[g.dtype],
                int(loop == "flat_binary"))
    return dx


def launch_scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, *, loop: Optional[str] = None
                           ) -> torch.Tensor:
    """K6: ``relu(x * scale + bias)`` over x's last dim (the channels),
    float32 ``scale`` and ``bias`` of that length; x's dtype out.  The loop
    is :func:`elementwise_plan`'s; ``loop="flat_binary"`` asks for the one
    it ran before, kept to be timed beside it."""
    _check_elementwise(x)
    c = _check_channels("K6", x, scale, bias)
    out = torch.empty_like(x)
    if x.numel():
        ptrs = (x.data_ptr(), out.data_ptr(), scale.data_ptr(),
                bias.data_ptr())
        p = _ew_plan("scale_bias_relu", x, ptrs, loop)
        _launch("hvd_scale_bias_relu", elementwise_launches,
                "scale_bias_relu", x.device, x.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), x.numel() // c, c,
                _DTYPES[x.dtype], int(p.loop == "flat_binary"))
    return out


def launch_scale_bias_relu_bwd(x: torch.Tensor, scale: torch.Tensor,
                               out: torch.Tensor, g: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """K6's backward from its input ``x``, ``scale``, its output ``out``
    and the upstream gradient ``g`` (all channels-last, contiguous):
    ``(dx, dscale, dbias)``, dx in x's dtype, the sums float32 ``[C]``
    over every row.  One pass writes dx and each block's sums into a
    ``[2, blocks, C]`` float32 scratch from the caching allocator (safe
    inside a CUDA graph), a second adds them in a fixed order; the route
    and the blocks are :func:`elementwise_plan`'s."""
    _check_elementwise(x, out, g)
    c = _check_channels("K6's backward", x, scale)
    dx = torch.empty_like(x)
    # the second pass writes every channel's sums; with no rows nothing
    # runs, and the sums are 0
    sums = torch.empty if x.numel() else torch.zeros
    dscale = sums(c, dtype=torch.float32, device=x.device)
    dbias = sums(c, dtype=torch.float32, device=x.device)
    if x.numel():
        ptrs = (x.data_ptr(), out.data_ptr(), g.data_ptr(), dx.data_ptr(),
                scale.data_ptr())
        p = _ew_plan("scale_bias_relu_bwd", x, ptrs)
        partial = torch.empty((2, p.blocks, c), dtype=torch.float32,
                              device=x.device)
        _launch("hvd_scale_bias_relu_bwd", elementwise_launches,
                "scale_bias_relu_bwd", x.device, x.data_ptr(),
                scale.data_ptr(), out.data_ptr(), g.data_ptr(),
                dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
                dbias.data_ptr(), x.numel() // c, c, _DTYPES[x.dtype],
                int(p.loop == "general"), p.blocks)
    return dx, dscale, dbias


def _check_conv(x: torch.Tensor, w: torch.Tensor,
                vectors: Tuple[torch.Tensor, ...] = ()) -> None:
    """Raises on anything K8-K10 do not take: device, dtype, shape,
    layout."""
    _check_on_card("K8-K10", [x, w, *vectors])
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError("K8-K10 take float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != \
            (3, 3, x.shape[3]) or 0 in (*x.shape, w.shape[3]):
        raise ValueError(f"K8-K10 take NHWC x [B, H, W, Cin] and w "
                         f"[3, 3, Cin, Cout], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("K8-K10 take contiguous NHWC x and HWIO w, got "
                         f"strides {x.stride()}, {w.stride()}")
    for t in vectors:
        if t.dtype != torch.float32 or t.shape != (w.shape[3],) or \
                not t.is_contiguous():
            raise ValueError(f"K8 takes contiguous float32 scale and bias "
                             f"[{w.shape[3]}], got {t.dtype} "
                             f"{tuple(t.shape)}")


class ConvPlan(NamedTuple):
    """How K8-K10 run one launch: the mainloop (``"wgmma"``,
    ``"mma_sync"`` or ``"f32"``), its output tile, the row tiles of the
    launch, which size K9's scratch (``[2, row_tiles, Cout]``), and the
    blocks of a ``wgmma`` launch (0 for the other mainloops, whose grid
    is one block a tile)."""

    mainloop: str
    tile_m: int
    tile_n: int
    row_tiles: int
    blocks: int


def conv3x3_plan(x_shape: Tuple[int, ...], cout: int, dtype: torch.dtype,
                 x_ptr: int, w_ptr: int, sms: int,
                 blocks_per_sm: int) -> ConvPlan:
    """The dispatch rule and schedule of K8-K10 (csrc/conv_bn.cu's
    header), for NHWC ``x_shape`` and HWIO weights with ``cout`` outputs
    at addresses ``x_ptr`` and ``w_ptr``, on a card of ``sms`` SMs that
    each hold ``blocks_per_sm`` blocks of the ``wgmma`` mainloop at once:

    * bfloat16 whose Cin and Cout are multiples of 8 and whose x and w
      start on 16-byte boundaries (what TMA can address): the TMA +
      ``wgmma`` mainloop, 128-pixel tiles, ``tile_n`` 128 when Cout > 64
      and the 128-wide grid still gives two tiles for every SM, else 64;
      as many blocks as the card holds at once, each walking its tiles,
      when there are :data:`WGMMA_PERSIST_WAVES` tiles for each, else one
      block a tile;
    * any other bfloat16 operands: the ``mma.sync`` mainloop, 128 x 64;
    * float32: the scalar kernel, 64 x 64.
    """
    b, h, wd, cin = x_shape
    m = b * h * wd
    if dtype == torch.float32:
        return ConvPlan("f32", 64, 64, -(-m // 64), 0)
    if dtype != torch.bfloat16:
        raise TypeError(f"K8-K10 take float32 or bfloat16, got {dtype}")
    row_tiles = -(-m // 128)
    if cin % 8 or cout % 8 or x_ptr % 16 or w_ptr % 16:
        return ConvPlan("mma_sync", 128, 64, row_tiles, 0)
    wide = cout > 64 and row_tiles * -(-cout // 128) >= 2 * sms
    tile_n = 128 if wide else 64
    tiles = row_tiles * -(-cout // tile_n)
    slots = sms * blocks_per_sm
    blocks = slots if tiles >= WGMMA_PERSIST_WAVES * slots else tiles
    return ConvPlan("wgmma", 128, tile_n, row_tiles, blocks)


@functools.lru_cache(maxsize=None)
def wgmma_card(index: int) -> Tuple[int, int]:
    """(SMs, blocks of the ``wgmma`` mainloop one SM holds at once) of CUDA
    card ``index``, for :func:`conv3x3_plan`; asked once per card.  The
    blocks are the fewer of the two tile widths'."""
    lib = load()
    per_sm = []
    with torch.cuda.device(index):
        for tile_n in (64, 128):
            n = ctypes.c_int32(0)
            err = lib.hvd_conv3x3_wgmma_occupancy(tile_n, ctypes.byref(n))
            if err:
                raise RuntimeError(f"hvd_conv3x3_wgmma_occupancy failed: "
                                   f"CUDA error {err}")
            per_sm.append(n.value)
    return card_sms(index), min(per_sm)


def conv3x3_stats_scratch(plan: ConvPlan, cout: int,
                          device: torch.device) -> torch.Tensor:
    """K9's scratch: the column sums of acc and of acc^2 of every row
    tile, ``[2, plan.row_tiles, cout]`` float32, added in order by the
    kernel's second pass."""
    return torch.empty((2, plan.row_tiles, cout), dtype=torch.float32,
                       device=device)


def launch_conv3x3(kind: str, x: torch.Tensor, w: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None, *,
                   mainloop: Optional[str] = None):
    """The 3x3 SAME stride-1 conv of NHWC ``x`` with HWIO ``w`` and one of
    three epilogues: ``"plain"`` (K10) returns y; ``"stats"`` (K9)
    returns ``(y, sum, sumsq)``, the sums float32 ``[Cout]`` over the
    float32 accumulator; ``"bn_relu"`` (K8) returns ``relu(acc * scale +
    bias)``.  y is NHWC in x's dtype.  The mainloop is
    :func:`conv3x3_plan`'s; ``mainloop="mma_sync"`` asks for that one on
    bfloat16 operands instead (``chip_smoke.py`` times the two side by
    side)."""
    if kind not in _CONV_EPILOGUES:
        raise ValueError(f"unknown conv epilogue {kind!r}")
    vectors = (scale, bias) if kind == "bn_relu" else ()
    if kind == "bn_relu" and (scale is None or bias is None):
        raise ValueError("K8 needs scale and bias")
    _check_conv(x, w, vectors)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    if mainloop is not None and (mainloop != "mma_sync" or
                                 x.dtype != torch.bfloat16):
        raise ValueError(f"K8-K10 take mainloop='mma_sync' on bfloat16 "
                         f"alone, got {mainloop!r} on {x.dtype}")
    plan = conv3x3_plan(tuple(x.shape), cout, x.dtype, x.data_ptr(),
                        w.data_ptr(), *wgmma_card(x.device.index))
    if mainloop is not None:
        plan = plan._replace(mainloop=mainloop, tile_n=64, blocks=0)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    args = _ConvArgs(x=x.data_ptr(), w=w.data_ptr(), y=y.data_ptr(), b=b,
                     h=h, wd=wd, cin=cin, cout=cout, tiles=plan.row_tiles,
                     epilogue=_CONV_EPILOGUES[kind], dtype=_DTYPES[x.dtype],
                     mainloop=_CONV_BF16_MAINLOOPS.get(plan.mainloop, 0),
                     tile_n=plan.tile_n, blocks=plan.blocks)
    if kind == "bn_relu":
        args.scale, args.bias = scale.data_ptr(), bias.data_ptr()
    sums = ()
    if kind == "stats":
        partial = conv3x3_stats_scratch(plan, cout, x.device)
        sums = (torch.empty(cout, dtype=torch.float32, device=x.device),
                torch.empty(cout, dtype=torch.float32, device=x.device))
        args.partial = partial.data_ptr()
        args.sum, args.sumsq = sums[0].data_ptr(), sums[1].data_ptr()
    _launch("hvd_conv3x3", conv_bn_launches, f"{kind}.{plan.mainloop}",
            x.device, ctypes.byref(args))
    return (y, *sums) if sums else y
