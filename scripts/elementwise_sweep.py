"""Time K6 (the norm+activation join), its backward and K7 (the residual
join) over the blocks their loops were chosen from, on one NVIDIA card.

The library (horovod_tpu_torch/csrc/elementwise.cu) launches one block of
each loop: the channel loop of K6 and the stream loop of K7 at 128 threads
x 2 packs of 16 bytes a thread, K6's backward at 256 x 4 on at most 2
blocks an SM.  This script builds scripts/elementwise_sweep.cu, the same
kernels at 128-512 threads x 1-4 packs (and the backward over grids of
1-8 blocks an SM), holds every one against the plain PyTorch versions (K6
and K7 bit for bit, the backward's dx bit for bit and its sums relative to
each channel's sum of |terms|, as ``chip_smoke.py`` holds them), then
times each, by the median of 25 calls between CUDA events as
``chip_smoke.py`` times, in bf16 at ResNet-50's shapes with batch 128 (K6:
the 20 ``BatchNormReLU`` joins' eight shapes; K7: the 16 block outputs'
four) and at the serving buckets' batches 1 and 32 (forwards only),
beside the library's launch and the flat_binary loop K6 and K7 ran before.

The calls of that timing reuse their operands, which stay in the 50 MB L2
where they fit.  So K7 is also timed on both loops with L2 flushed before
each call (a 256 MB write between calls, outside the events).

Prints the ptxas report of the library's elementwise kernels (stderr), the
card's name and power limit and one JSON line: the best block of each
kernel at each shape with its ms, the library's and flat_binary's; the
sums of launches x ms over each batch's joins; and the flushed K7 times.
The whole table goes to ``--out``.  Exits non-zero without a card or on a
mismatch.

Usage: python3 scripts/elementwise_sweep.py [--out build/ew_sweep.json]
"""

from __future__ import annotations

import argparse
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

import chip_smoke  # noqa: E402
from horovod_tpu_torch import kernels  # noqa: E402
from horovod_tpu_torch.ops import elementwise as ew  # noqa: E402

SOURCE = ROOT / "scripts" / "elementwise_sweep.cu"
LIB = ROOT / "build" / "elementwise_sweep" / "libelementwise_sweep.so"
#: (threads, packs a thread) of the forward loops
BLOCKS = [(t, p) for t in (128, 256, 512) for p in (1, 2, 4)]
#: (threads, packs) of the backward, and its blocks an SM / rounds a block
BWD_BLOCKS = [(128, 2), (256, 1), (256, 2), (256, 4), (512, 1), (512, 2)]
BWD_GRIDS = [(bps, r) for bps in (1, 2, 4, 8) for r in (1, 4)]
#: bytes written between two calls of the flushed timing: over 5x the L2
FLUSH_BYTES = 256 << 20


def build() -> ctypes.CDLL:
    LIB.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                    f"-I{kernels.CSRC}", str(SOURCE), "-o", str(LIB)],
                   check=True)
    lib = ctypes.CDLL(str(LIB))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.sweep_residual_relu.argtypes = [p, p, p, i64, i32, i32, p]
    lib.sweep_scale_bias_relu.argtypes = [p, p, p, p, i64, i64, i32, i32, p]
    lib.sweep_scale_bias_relu_bwd.argtypes = [p] * 8 + [i64, i64] + [
        i32] * 3 + [p]
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _checked(err: int, what) -> None:
    if err:
        raise RuntimeError(f"elementwise_sweep: {what}: CUDA error {err}")


def residual(lib, block, x, y):
    out = torch.empty_like(x)
    _checked(lib.sweep_residual_relu(x.data_ptr(), y.data_ptr(),
                                     out.data_ptr(), x.numel(), *block,
                                     _stream()), ("K7", block))
    return out


def affine(lib, block, x, scale, bias):
    out = torch.empty_like(x)
    c = x.shape[-1]
    _checked(lib.sweep_scale_bias_relu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        x.numel() // c, c, *block, _stream()), ("K6", block))
    return out


def affine_bwd(lib, block, blocks, x, scale, out, g):
    c = x.shape[-1]
    dx = torch.empty_like(x)
    partial = torch.empty((2, blocks, c), dtype=torch.float32,
                          device=x.device)
    ds = torch.empty(c, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    _checked(lib.sweep_scale_bias_relu_bwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), g.data_ptr(),
        dx.data_ptr(), partial.data_ptr(), ds.data_ptr(), db.data_ptr(),
        x.numel() // c, c, *block, blocks, _stream()),
        ("K6's backward", block, blocks))
    return dx, ds, db


def flushed_ms(fn, flush, runs: int = chip_smoke.TIMED_RUNS) -> float:
    """Median device time of ``fn`` over ``runs`` calls between CUDA
    events, each after ``flush`` was overwritten: no operand of ``fn`` is
    left in L2 when it starts."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(1)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _key(shape) -> str:
    return "x".join(map(str, shape))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("elementwise_sweep: no CUDA card", file=sys.stderr)
        return 1
    log = kernels.build(force=True, verbose=True)
    print("\n".join(line for line in log.split("== elementwise.cu")[1]
                    .split("== ")[0].splitlines()
                    if "registers" in line or "Compiling" in line
                    or "spill" in line), file=sys.stderr)
    lib = build()
    sms = kernels.card_sms(0)
    table = {"K6": {}, "K6_bwd": {}, "K7": {}}
    worst_sum_err = 0.0
    dt = torch.bfloat16
    batches = chip_smoke.EW_BATCHES
    shapes = {
        "K6": [((b, s, s, c), k) for b in batches
               for s, c, k in chip_smoke.K6_PATH_SHAPES],
        "K7": [((b, s, s, c), k) for b in batches
               for s, c, k in chip_smoke.K7_PATH_SHAPES]}
    for shape, _ in shapes["K6"]:
        x = chip_smoke._seeded(shape, dt, 1)
        c = shape[-1]
        scale = torch.rand(c, device="cuda") + 0.5
        bias = torch.randn(c, device="cuda")
        want = ew.plain_scale_bias_relu(x, scale, bias)
        row = {"library": chip_smoke.cuda_ms(
            lambda: kernels.launch_scale_bias_relu(x, scale, bias)),
            "flat_binary": chip_smoke.cuda_ms(
                lambda: kernels.launch_scale_bias_relu(
                    x, scale, bias, loop="flat_binary"))}
        for block in BLOCKS:
            if block[0] % (c // 8):
                continue
            if not torch.equal(affine(lib, block, x, scale, bias), want):
                print(f"elementwise_sweep: K6 {block} differs at {shape}",
                      file=sys.stderr)
                return 1
            row[_key(block)] = chip_smoke.cuda_ms(
                lambda: affine(lib, block, x, scale, bias))
        table["K6"][_key(shape)] = row
        if shape[0] != batches[0]:  # the backward runs in training alone
            continue
        out = want
        g = chip_smoke._seeded(shape, dt, 2)
        pdx, pds, pdb = ew.plain_scale_bias_relu_bwd(x, scale, out, g)
        gm = ew.plain_relu_grad(out, g).float().reshape(-1, c)
        xf = x.float().reshape(-1, c)
        row = {"library": chip_smoke.cuda_ms(
            lambda: kernels.launch_scale_bias_relu_bwd(x, scale, out, g)),
            "old_tail": chip_smoke.cuda_ms(
                lambda: chip_smoke.k6_old_tail(ew, x, scale, out, g))}
        n_vec = math.prod(shape) // 8
        for block in BWD_BLOCKS:
            rounds = -(-n_vec // (block[0] * block[1]))
            for bps, least in BWD_GRIDS:
                blocks = max(1, min(sms * bps, rounds // least))
                dx, ds, db = affine_bwd(lib, block, blocks, x, scale, out,
                                        g)
                err = max(chip_smoke.ew_sum_err(ds, pds, gm * xf),
                          chip_smoke.ew_sum_err(db, pdb, gm))
                worst_sum_err = max(worst_sum_err, err)
                if not torch.equal(dx, pdx) or \
                        not err <= chip_smoke.EW_SUM_RTOL:
                    print(f"elementwise_sweep: K6's backward {block} on "
                          f"{blocks} blocks at {shape}: dx equal "
                          f"{torch.equal(dx, pdx)}, sum error {err}",
                          file=sys.stderr)
                    return 1
                row[f"{_key(block)}/{bps}/{least}"] = chip_smoke.cuda_ms(
                    lambda: affine_bwd(lib, block, blocks, x, scale, out,
                                       g))
        table["K6_bwd"][_key(shape)] = row
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flushed = {}
    for shape, _ in shapes["K7"]:
        x = chip_smoke._seeded(shape, dt, 3)
        y = chip_smoke._seeded(shape, dt, 4)
        want = ew.plain_residual_relu(x, y)
        library = lambda: kernels.launch_residual_relu(x, y)  # noqa: E731
        flat = lambda: kernels.launch_residual_relu(  # noqa: E731
            x, y, loop="flat_binary")
        row = {"library": chip_smoke.cuda_ms(library),
               "flat_binary": chip_smoke.cuda_ms(flat)}
        for block in BLOCKS:
            if not torch.equal(residual(lib, block, x, y), want):
                print(f"elementwise_sweep: K7 {block} differs at {shape}",
                      file=sys.stderr)
                return 1
            row[_key(block)] = chip_smoke.cuda_ms(
                lambda: residual(lib, block, x, y))
        table["K7"][_key(shape)] = row
        flushed[_key(shape)] = {"library": flushed_ms(library, flush),
                                "flat_binary": flushed_ms(flat, flush)}
    del flush

    best = {}
    for kernel, rows in table.items():
        best[kernel] = {}
        for key, row in rows.items():
            timed = {k: v for k, v in row.items()
                     if k not in ("library", "flat_binary", "old_tail")}
            b = min(timed, key=timed.get)
            best[kernel][key] = {"best": b, "ms": timed[b],
                                 **{k: row[k] for k in ("library",
                                                        "flat_binary",
                                                        "old_tail")
                                    if k in row}}
    # launches x ms over each batch's joins (K6's backward: batch 128)
    sums = {}
    for kernel, name in (("K6", "K6"), ("K6_bwd", "K6"), ("K7", "K7")):
        for batch in batches:
            launches = {_key(s): k for s, k in shapes[name]
                        if s[0] == batch}
            if not all(key in table[kernel] for key in launches):
                continue
            cols = [c for c in ("library", "flat_binary", "old_tail")
                    if c in table[kernel][next(iter(launches))]]
            sums[f"{kernel}@{batch}"] = {
                col: sum(table[kernel][key][col] * k
                         for key, k in launches.items()) for col in cols}
            if kernel == "K7":
                sums[f"{kernel}@{batch}"]["flushed"] = {
                    col: sum(flushed[key][col] * k
                             for key, k in launches.items())
                    for col in ("library", "flat_binary")}
    print(chip_smoke.nvidia_smi_line())
    result = {"sms": sms, "worst_sum_err": worst_sum_err, "best": best,
              "sums": sums, "k7_flushed": flushed}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**result, "table": table},
                                             indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
