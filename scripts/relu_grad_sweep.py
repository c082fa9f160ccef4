"""Time K6' (the ReLU gradient of the port's ResNet joins) against the loops
it was chosen from, on one NVIDIA card.

K6' computes dx = where(float(out) > 0, g, 0).  The port's library
(horovod_tpu_torch/csrc/elementwise.cu) keeps one loop for it: two 16-byte
packs of each operand a thread, loaded before use, a block for each round,
default cache policy.  This script builds scripts/relu_grad_sweep.cu, the
loops that loop was chosen from:

* the streaming pass at U = 2, 4 or 8 packs a thread, with no cache hint,
  with evict-first loads and stores (``cs``) or with non-coherent loads
  that skip L1 and evict-first stores (``nc``), over three schedules: one
  resident wave of blocks each over a contiguous ``chunk``, one wave over
  interleaved rounds (``stride``), a block for each round (``grid``);
* a ring of 1-D TMA bulk copies (``bulk``) at U = 2, 4 and 8.

Every loop is held bit for bit against the plain PyTorch version in
float32 and bf16 at an aligned, a ragged and a misaligned size; then each
is timed at ResNet-50's largest join, [128, 56, 56, 256] bf16, in one
process beside the library's K6', its flat_binary loop and
``aten.threshold_backward``, by the median of 25 calls between CUDA
events, as chip_smoke.py times.  Prints the card's name and power limit
and one JSON line; exits non-zero without a card or on a mismatch.

Usage: python3 scripts/relu_grad_sweep.py
"""

from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from horovod_tpu_torch import kernels  # noqa: E402
from horovod_tpu_torch.ops import elementwise as ew  # noqa: E402

SOURCE = ROOT / "scripts" / "relu_grad_sweep.cu"
LIB = ROOT / "build" / "relu_grad_sweep" / "librelu_grad_sweep.so"
SCHEDULES = {"chunk": 1, "stride": 2, "grid": 3, "bulk": 4}
HINTS = {"none": 0, "cs": 1, "nc": 2}
LOOPS = [(s, u, h) for s in ("chunk", "stride", "grid") for u in (2, 4, 8)
         for h in HINTS] + [("bulk", u, "none") for u in (2, 4, 8)]
SHAPE = (128, 56, 56, 256)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def build() -> ctypes.CDLL:
    LIB.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                    f"-I{kernels.CSRC}", str(SOURCE), "-o", str(LIB)],
                   check=True)
    lib = ctypes.CDLL(str(LIB))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.sweep_relu_grad.argtypes = [p, p, p, i64, i32, i32, i32, i32, p]
    return lib


def run(lib, loop, out, g):
    dx = torch.empty_like(g)
    s, u, h = loop
    err = lib.sweep_relu_grad(
        out.data_ptr(), g.data_ptr(), dx.data_ptr(), g.numel(),
        0 if g.dtype == torch.float32 else 1, SCHEDULES[s], u, HINTS[h],
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"loop {loop}: CUDA error {err}")
    return dx


def cuda_ms(fn, runs=25, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def seeded(shape, dtype, seed, offset=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    if not offset:
        return x
    buf = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)
    return buf[1:].view(shape).copy_(x)


def main() -> int:
    if not torch.cuda.is_available():
        print("relu_grad_sweep: no CUDA card", file=sys.stderr)
        return 1
    lib = build()
    for dtype in (torch.float32, torch.bfloat16):
        for shape, offset in ((SHAPE, False), ((3, 5, 7, 36), False),
                              ((2, 5, 7, 64), True)):
            out = seeded(shape, dtype, 1, offset)
            g = seeded(shape, dtype, 2)
            want = ew.plain_relu_grad(out, g)
            for loop in LOOPS:
                if not torch.equal(run(lib, loop, out, g), want):
                    print(f"relu_grad_sweep: {loop} differs at {shape} "
                          f"{dtype} offset={offset}", file=sys.stderr)
                    return 1
    out = seeded(SHAPE, torch.bfloat16, 1)
    g = seeded(SHAPE, torch.bfloat16, 2)
    ms = {"library": cuda_ms(lambda: kernels.launch_relu_grad(out, g)),
          "flat_binary": cuda_ms(lambda: kernels.launch_relu_grad(
              out, g, loop="flat_binary")),
          "threshold_backward": cuda_ms(
              lambda: torch.ops.aten.threshold_backward(g, out, 0.0))}
    for loop in LOOPS:
        ms[".".join(map(str, loop))] = cuda_ms(lambda: run(lib, loop, out, g))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"shape": list(SHAPE), "dtype": "bfloat16",
                      "bound_ms": 3 * 2 * math.prod(SHAPE)
                      / HBM_BYTES_PER_S * 1e3, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
