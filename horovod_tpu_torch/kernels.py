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
from typing import Dict, List, Optional

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

_lib: Optional[ctypes.CDLL] = None


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
    for fn in (lib.hvd_sgd_f32, lib.hvd_momentum_f32, lib.hvd_adam_f32):
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
