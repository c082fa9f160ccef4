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
import fcntl
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "horovod_tpu_torch"
LIB_PATH = BUILD_DIR / "libhvd_torch_kernels.so"

#: Hopper with its architecture-specific features; --fmad=false keeps
#: every multiply and add rounded separately, as the plain versions round
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

#: launches of K1 per update rule, counted where the kernel is launched
fused_update_launches: Dict[str, int] = {"sgd": 0, "momentum": 0,
                                         "adam": 0}
#: launches of K2 (fwd), K3 (bwd_dq) and K4 (bwd_dkv), counted likewise
flash_launches: Dict[str, int] = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

#: head dims with a template instance in csrc/flash_attention.cu
FLASH_HEAD_DIMS = (16, 32, 64, 128)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None


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
                                                 "dtype")])


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
    lib.hvd_sgd_f32.argtypes = [ptr, ptr, i64, f32, ptr]
    lib.hvd_momentum_f32.argtypes = [ptr, ptr, ptr, i64, f32, f32, ptr]
    lib.hvd_adam_f32.argtypes = [ptr, ptr, ptr, ptr, i64] + [f32] * 8 + [ptr]
    flash = (lib.hvd_flash_fwd, lib.hvd_flash_bwd_dq, lib.hvd_flash_bwd_dkv)
    for fn in flash:
        fn.argtypes = [ctypes.POINTER(_FlashArgs), ptr]
    for fn in (lib.hvd_sgd_f32, lib.hvd_momentum_f32, lib.hvd_adam_f32,
               *flash):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(tensors: List[torch.Tensor]) -> None:
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(
                f"K1 takes CUDA tensors on one device, got {t.device} "
                f"beside {first.device}")
        if t.dtype != torch.float32:
            raise TypeError(
                f"K1 takes float32 buffers, got {t.dtype} (bf16 parameter "
                "groups are still to be ported)")
        if not t.is_contiguous():
            raise ValueError("K1 takes contiguous flat buffers")
        if t.numel() != first.numel():
            raise ValueError(
                f"K1 buffers differ in length: {t.numel()} vs "
                f"{first.numel()}")


def launch_fused_update(kind: str, p: torch.Tensor, g: torch.Tensor,
                        mu: Optional[torch.Tensor] = None,
                        nu: Optional[torch.Tensor] = None, *, lr: float,
                        momentum: float = 0.0, b1: float = 0.0,
                        b2: float = 0.0, eps: float = 0.0,
                        one_minus_b1: float = 0.0, one_minus_b2: float = 0.0,
                        inv_bc1: float = 1.0, inv_bc2: float = 1.0) -> None:
    """Launch K1's ``kind`` rule in place over flat float32 CUDA buffers
    on the current stream.  Raises on anything the kernel does not take
    and on a launch the CUDA runtime refuses."""
    bufs = {"sgd": [p, g], "momentum": [p, g, mu], "adam": [p, g, mu, nu]}
    if kind not in bufs:
        raise ValueError(f"unknown fused update rule {kind!r}")
    if any(t is None for t in bufs[kind]):
        raise ValueError(f"the {kind} rule needs its moment buffers")
    _check(bufs[kind])
    n = p.numel()
    if n == 0:
        return
    lib = load()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        ptrs = [t.data_ptr() for t in bufs[kind]]
        if kind == "sgd":
            err = lib.hvd_sgd_f32(*ptrs, n, lr, stream)
        elif kind == "momentum":
            err = lib.hvd_momentum_f32(*ptrs, n, lr, momentum, stream)
        else:
            err = lib.hvd_adam_f32(*ptrs, n, lr, b1, b2, eps, one_minus_b1,
                                   one_minus_b2, inv_bc1, inv_bc2, stream)
    if err:
        raise RuntimeError(f"K1 {kind} launch failed: CUDA error {err}")
    fused_update_launches[kind] += 1


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
    if q.dtype not in _FLASH_DTYPES or any(t.dtype != q.dtype for t in ops):
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
    for t in ops + list(stats):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"K2-K4 take CUDA tensors on one device, got {t.device} "
                f"beside {q.device}")


def _flash_args(q, k, v, *, causal: bool, scale: float, q_offset: int,
                kv_offset: int, normalize: bool = True, **operands
                ) -> _FlashArgs:
    b, h, sq, d = q.shape
    a = _FlashArgs(q=_bhsd(q), k=_bhsd(k), v=_bhsd(v), b=b, h=h, sq=sq,
                   sk=k.shape[2], d=d, q_off=int(q_offset),
                   kv_off=int(kv_offset), scale=float(scale),
                   causal=int(bool(causal)), normalize=int(bool(normalize)),
                   dtype=_FLASH_DTYPES[q.dtype])
    for name, t in operands.items():
        if name in ("m", "l", "lse", "delta"):
            setattr(a, name, t.data_ptr())
        else:
            setattr(a, name, _bhsd(t))
    return a


def _run_flash(fn_name: str, counter: str, args: _FlashArgs,
               device: torch.device) -> None:
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(ctypes.byref(args), stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    flash_launches[counter] += 1


def launch_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, scale: float, q_offset: int = 0,
                     kv_offset: int = 0, normalize: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on [b, h, s, d] CUDA tensors: ``(o, m, l)``, o in q's dtype
    (``normalize``) or float32, m and l float32 ``[b, h, sq, 1]``."""
    _check_flash(q, k, v)
    b, h, sq, _ = q.shape
    o = torch.empty_like(q, dtype=q.dtype if normalize else torch.float32)
    m = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    args = _flash_args(q, k, v, causal=causal, scale=scale,
                       q_offset=q_offset, kv_offset=kv_offset,
                       normalize=normalize, o=o, m=m, l=l)
    _run_flash("hvd_flash_fwd", "fwd", args, q.device)
    return o, m, l


def launch_flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                        scale: float, q_offset: int = 0,
                        kv_offset: int = 0) -> torch.Tensor:
    """K3: dq in float32, laid out like q."""
    _check_flash(q, k, v, do, (lse, delta))
    dq = torch.empty_like(q, dtype=torch.float32)
    args = _flash_args(q, k, v, causal=causal, scale=scale,
                       q_offset=q_offset, kv_offset=kv_offset, dout=do,
                       lse=lse, delta=delta, dq=dq)
    _run_flash("hvd_flash_bwd_dq", "bwd_dq", args, q.device)
    return dq


def launch_flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                         scale: float, q_offset: int = 0, kv_offset: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(dk, dv)`` in float32, laid out like k and v."""
    _check_flash(q, k, v, do, (lse, delta))
    dk = torch.empty_like(k, dtype=torch.float32)
    dv = torch.empty_like(v, dtype=torch.float32)
    args = _flash_args(q, k, v, causal=causal, scale=scale,
                       q_offset=q_offset, kv_offset=kv_offset, dout=do,
                       lse=lse, delta=delta, dk=dk, dv=dv)
    _run_flash("hvd_flash_bwd_dkv", "bwd_dkv", args, q.device)
    return dk, dv
