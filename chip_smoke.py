#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``horovod_tpu_torch``) on one NVIDIA
card, end to end, and check what comes out.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name, and its name and power limit as nvidia-smi
   reports them.
2. build   — compiles the hand-written kernels from ``csrc/`` with nvcc.
3. kernels — each rule of K1 (the flat fused optimizer update) against
   its plain PyTorch version on the same seeded inputs, over 3 steps, at
   ResNet-50's 25,557,032 parameters and at a ragged 1,000,003, and adam
   also at GPT-2 small's 124,439,808; then each rule's time (CUDA events,
   median of 25) at the size of its main path (GPT-2 small's for adam,
   ResNet-50's for the others) beside the plain version's,
   ``torch.optim``'s fused step on the same buffers (timed only, the port
   never calls it) and the bound from the bytes it must move.  The same
   for bf16 groups: each rule bit for bit against its plain version over
   3 steps (main-path and ragged lengths, and one element off 16-byte
   alignment), then timed beside ``torch.optim``'s fused step on bf16
   parameters.  K1 counts its launches by rule and group type, so each
   rule's entry in the kernels line gives its main path's float32
   launches and its ``bf16`` block that path's bf16 launches.
4. flash_kernels — K2, K3 and K4 (flash attention forward, dq, dk/dv)
   against their plain versions on the same seeded inputs: GPT-2 small's
   shape (b 4, h 12, s 1024, d 64) in bf16, causal, in the model's
   [b, s, h, d] layout; in float32 and in bf16, ragged lengths 136 and
   192, causal and not, head dims 16, 32 and 128, unnormalized at
   nonzero offsets including a kv shard wholly in the future (l exactly
   0, o finite), and operands off 16-byte alignment; float32 outputs
   elementwise, bf16 ones row by row in norm (``FLASH_BF16_ROW_LIMIT``,
   ``FLASH_BF16_MEAN_LIMIT``).  Then each kernel's
   time at GPT-2 small's shape and layout beside its plain version's,
   its bound, and ``F.scaled_dot_product_attention``'s forward (for K2)
   and backward (for K3 and K4 together), timed only.
5. parity  — a narrow ResNet-18 at 64×64 trained 2 steps in float32 from
   the same seeded weights on the card (K1) and on the CPU (plain), with
   TF32 off for convolutions and matmuls; losses, parameters and
   BatchNorm statistics compared.
6. gpt_parity — a float32 GPT of gpt_tiny's shape (2 layers, hidden 64,
   4 heads, vocab 256, seq 136) trained 2 fused-Adam steps on the card
   (K1-K4) and on the CPU (plain), TF32 off, from three seeds; losses and
   parameters.  Then gpt_bf16 — a bf16 GPT with GPT-2 small's head dim
   64 (2 layers, hidden 128, seq 320), one forward and backward on the
   card through K2-K4 and through their plain versions
   (``plain_flash_attention``) from the same weights and ids, three
   seeds: the loss and every parameter's gradient.
7. main path — ``examples.synthetic_benchmark.run``: ResNet-50, 224×224,
   batch 128, bf16, ``--fused-optimizer``, world size 1 over NCCL.  Checks
   a finite loss, one K1 launch per step and one gradient ``all_reduce``
   per fusion bucket per step; reports img/s and MFU.
8. profile — 3 more ResNet-50 steps under torch.profiler: device time
   per step by kind of kernel and the device's idle share.
9. elementwise_kernels — K6, K6' and K7 (the ResNet joins) against their
   plain versions, bit for bit, in bf16 and float32 at ResNet-50's join
   shapes, a ragged row count, C = 36, an operand off 16-byte alignment
   and the expanded gradient of the final mean; then each kernel's time
   at [128, 56, 56, 256] bf16 beside its plain version's, its bound and,
   for K6', ``threshold_backward`` (timed only).
10. conv_kernels — K8, K9 and K10 (the fused 3x3 conv's three epilogues)
   against their plain versions at ResNet-50's four stride-1 3x3 shapes
   in bf16 (row by row in norm, ``CONV_BF16_*``) on the TMA + wgmma
   mainloop and on mma.sync, and in float32, then at small float32,
   rectangular, odd-size, C = 24, 3-channel and misaligned cases; K9's
   sums relative (``CONV_SUM_RTOL``); each case's launches must name the
   mainloop ``kernels.conv3x3_plan`` gives it.  Then each kernel's time
   at the four shapes on both bf16 mainloops beside its plain version's,
   its bound and ``F.conv2d``'s on channels-last bf16 (the conv alone,
   timed only).
11. variants_parity — narrow ResNet-18 and ResNet-50 with
   ``norm_act``, ``residual_join`` and ``conv_bn`` set to "pallas",
   trained 2 steps in float32 on the card (K6-K10, K1) and on the CPU
   (plain), TF32 off; losses, parameters, statistics, then the eval
   forward's logits (K8); launches counted against the models' modules.
12. variants_main_path — the synthetic benchmark with the three options:
   ResNet-50, 224x224, batch 128, bf16, fused momentum.  Checks a finite
   loss, per step K6 20, K6' 36, K7 16, K9 13, K10 13, K8 0, K1 momentum
   1, no flash launch and one gradient ``all_reduce`` per fusion bucket,
   every K9 and K10 launch on the TMA + wgmma mainloop; reports img/s,
   MFU and peak memory beside the default path's img/s; then one eval
   forward of a batch: K8 13 (all on TMA + wgmma), K9 0, finite logits.
13. variants_profile — 3 of those steps under torch.profiler, by kind
   (``K6-K7`` and ``K8-K10`` for the port's kernels).
14. rules   — the same trainer 3 steps each with fused SGD and fused Adam,
   so every K1 rule runs on a training path.
15. gpt_main_path — ``examples.gpt_synthetic_benchmark.run`` at its
   defaults: GPT-2 small, batch 4, seq 1024, bf16, flash attention,
   fused Adam, world size 1 over NCCL.  Checks a finite loss, K2, K3 and
   K4 each launched 12 times a step, K1 adam once a step, one gradient
   ``all_reduce`` per fusion bucket per step; reports seq/s and MFU.
16. gpt_profile — 3 GPT-2 small steps under torch.profiler, by kind
   (``flash`` for K2-K4, ``matmul`` for the projections).

Every kernel count is set to 0 just before each main path and read just
after it.  Then the ``{"kernels": [...]}`` line, the nvidia-smi line
and, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before the last line.

``--flash-only`` runs the device, build and flash_kernels phases alone
and prints no last line: the quick check of a change to K2-K4.
``--variants-only`` runs the device and build phases and phases 9-13,
then a kernels line of K6-K10, and prints no last line.
"""

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Tuple

import numpy as np
import torch

PARAMS_RESNET50 = 25_557_032
#: GPT-2 small's parameters: one flat float32 buffer on the GPT main path
PARAMS_GPT2_SMALL = 124_439_808
RAGGED = 1_000_003
TIMED_RUNS = 25
#: about 2 ms of the card's clock: longer than the host takes to queue any
#: timed call, so the card is still busy when the call's launches arrive
SLEEP_CYCLES = 4_000_000

#: K1 agrees with its plain version to the reference's own pinned
#: tolerance (tests/test_fused_update.py:65).  Built with --fmad=false,
#: each kernel rounds like the plain version, so the error is expected 0.
K1_RTOL, K1_ATOL = 2e-6, 1e-7

#: card-vs-CPU training parity: float32 on both sides with TF32 off; the
#: cuDNN and CPU convolutions sum in different orders, so the two agree
#: to float32 accumulation error, not bit for bit
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5

#: per rule: (kernel body it replaces, bytes and flops per element)
RULES = {
    "sgd": ("horovod_tpu/optim/fused_update.py:139", 3 * 4, 2),
    "momentum": ("horovod_tpu/optim/fused_update.py:143", 5 * 4, 4),
    "adam": ("horovod_tpu/optim/fused_update.py:149", 7 * 4, 14),
}


#: GPT-2 small's attention on the main path: batch 4, 12 heads, seq 1024,
#: head dim 64
GPT_ATTN_SHAPE = (4, 12, 1024, 64)

#: K2-K4 against their plain versions in float32, elementwise (rtol,
#: atol): both sum in float32 in other orders, and the JAX tests' own
#: tolerance against a dense oracle is 2e-4.
FLASH_TOL = {torch.float32: (2e-4, 2e-4)}
#: ... and in bfloat16, each output row (its last dim) in norm: the row
#: error ||got - plain|| / (||plain|| + FLASH_ROW_FLOOR * the mean row
#: norm).  The plain forward rounds p to bf16 per kv tile against the
#: running max, as the kernel does, so what is left is float32 summation
#: order and, where that tips a rounding, one bf16 ulp (2^-7 relative) of
#: an element of o or of one p or ds term of a sum: the largest row error
#: of o, dq, dk and dv is held to that ulp (sound runs read up to 2^-8, a
#: row dominated by one flipped term), of the float32 m and l to 1e-5
#: (read: up to 1.8e-6).  A fault that moves every row a little (p
#: truncated, not rounded: 6.7e-3 at most in a row) stays under the ulp,
#: so the mean row error is held too, to FLASH_BF16_MEAN_LIMIT, about 9x
#: the sound runs' worst mean (1.1e-5, o) and 40x below that fault's
#: (4.2e-3): in a sound run few rows hold a flipped rounding.  The floor
#: keeps rows far below the typical one (a fully masked row, an m near 0)
#: from asking for exactness.
FLASH_BF16_ROW_LIMIT = {"o": 2 ** -7, "m": 1e-5, "l": 1e-5,
                        "dq": 2 ** -7, "dk": 2 ** -7, "dv": 2 ** -7}
FLASH_BF16_MEAN_LIMIT = 1e-4
FLASH_ROW_FLOOR = 1e-2

#: GPT card-vs-CPU parity (float32, TF32 off).  Losses agree to float32
#: summation-order error.  Adam's first steps move each parameter by about
#: lr * sign(g): where a gradient is within rounding of 0 the two devices
#: may step it opposite ways, so a few parameters may differ by up to
#: 2 * lr per step; all others agree to float32 rounding of the update.
#: The share of parameters beyond GPT_PARAM_ATOL is about 3x the worst of
#: three seeds' readings (14, 4 and 1 of 149,120, key bias apart).
GPT_LOSS_RTOL = 1e-5
GPT_PARAM_ATOL = 1e-6
GPT_FLIP_BOUND = 2.0
GPT_FLIP_SHARE = 3e-4
#: the attention's key bias has an exact gradient of 0 (adding q.b to
#: every score of a row leaves the softmax unchanged), so Adam steps it on
#: rounding noise on both devices: exempt by name, bounded by
#: GPT_FLIP_BOUND * lr * steps alone, its gradient reported
KEY_BIAS = "key/bias"
GPT_PARITY_SEEDS = (3, 13, 23)

#: a bf16 GPT's step through K2-K4 against the same through their plain
#: versions: the loss, and each parameter's gradient in norm
#: (||g_kernels - g_plain|| / ||g_plain||), about 4-6x the worst of three
#: seeds' readings (loss 1.7e-5; gradients 8.5e-3, the position table's:
#: one-ulp differences of o carried through the bf16 layers)
GPT_BF16_LOSS_RTOL = 1e-4
GPT_BF16_GRAD_RTOL = 2 ** -5

#: per kernel: (name, the Pallas body it replaces)
FLASH_KERNELS = {
    "K2": ("flash_fwd", "horovod_tpu/ops/flash_attention.py:120"),
    "K3": ("flash_bwd_dq", "horovod_tpu/ops/flash_attention.py:235"),
    "K4": ("flash_bwd_dkv", "horovod_tpu/ops/flash_attention.py:290"),
}


#: the three ResNet options whose kernels are K6-K10
VARIANTS = {"norm_act": "pallas", "residual_join": "pallas",
            "conv_bn": "pallas"}
#: per kernel: (name, the Pallas body it replaces)
EW_KERNELS = {
    "K6": ("scale_bias_relu", "horovod_tpu/ops/elementwise.py:105"),
    "K6'": ("relu_grad", "horovod_tpu/ops/elementwise.py:39"),
    "K7": ("residual_relu", "horovod_tpu/ops/elementwise.py:35"),
}
CONV_KERNELS = {
    "K8": ("conv3x3_bn_relu", "horovod_tpu/ops/conv_bn.py:52"),
    "K9": ("conv3x3_stats", "horovod_tpu/ops/conv_bn.py:61"),
    "K10": ("conv3x3_plain", "horovod_tpu/ops/conv_bn.py:79"),
}
#: the largest residual join of ResNet-50 at batch 128: the timing shape
EW_SHAPE = (128, 56, 56, 256)
#: ResNet-50's stride-1 3x3 convs at batch 128: (spatial size, channels,
#: launches of each a step: the 3, 3, 5 and 2 stride-1 blocks of a stage)
CONV_SHAPES = ((56, 64, 3), (28, 128, 3), (14, 256, 5), (7, 512, 2))
#: launches a ResNet-50 train step with all three options makes: K6 in
#: bn_init, each block's first norm and the 3 stride-2 3x3 norms; K6' in
#: the backward of each K6 and K7; K7 in each of the 16 blocks; K9 and
#: K10 in the 13 stride-1 blocks' fused 3x3 (K8 runs in eval only)
VARIANT_STEP_LAUNCHES = {"scale_bias_relu": 20, "relu_grad": 36,
                         "residual_relu": 16, "stats": 13, "plain": 13}

#: K6, K6' and K7 against their plain versions: bit-equal.  The kernels
#: round where the plain versions round (built with --fmad=false), so
#: there is no summation order to differ in.
#: K8-K10 against their plain versions (the nine-tap matmuls in float32):
#: both sum the same float32 products in other orders.  float32 outputs
#: elementwise, rtol CONV_F32_RTOL plus CONV_F32_ATOL of the largest
#: output (the JAX tests' own 1e-4 against XLA's conv).  bf16 outputs row
#: by row in norm (``row_rel_err`` over Cout): a summation-order
#: difference of ~1e-6 flips the bf16 rounding of a few elements by one
#: ulp (2^-8 relative to a typical row), so the largest row error is
#: held to one ulp, 2^-7, and the mean row error to CONV_BF16_MEAN_LIMIT;
#: Sound runs read at most 4.3e-3 (largest) and 6.5e-5 (mean); planted
#: faults fail: the centre tap skipped reads 0.86 / 0.32, a truncating
#: bf16 cast (no rounding) 6.9e-3 / 3.9e-3, caught by the mean.
CONV_F32_RTOL, CONV_F32_ATOL = 1e-4, 1e-5
CONV_BF16_ROW_LIMIT = 2 ** -7
CONV_BF16_MEAN_LIMIT = 5e-4
#: K9's sums against the plain version's: |sum - plain| over the column's
#: sum of |y| and |sumsq - plain| over the plain sumsq.  The tensor cores'
#: float32 accumulation truncates in its alignment step, so each acc sits
#: a little toward zero and sumsq carries a one-sided bias that grows with
#: K = 9 Cin: sound runs read up to 1.4e-6 (Cin 64) to 8.0e-6 (Cin 512)
#: for sumsq, 2.4e-7 for sum; the limit is about 6x the worst.  A conv
#: missing a tap is off by ~0.1 or more.
CONV_SUM_RTOL = 5e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` calls, each between two
    CUDA events.  The card is held busy while the host queues the events
    and the call, so the host's time to launch the call (a wrapper's
    checks, its ctypes arguments) is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
def phase_kernels(fu, flops_mod):
    """K1 against its plain version, then timed.  Returns the per-rule
    measurements; the launches of the training paths are added later."""
    opts = {"sgd": fu.fused_sgd(0.01), "momentum": fu.fused_sgd(0.01, 0.9),
            "adam": fu.fused_adam(1e-3)}
    results = {}
    for rule, opt in opts.items():
        # each rule at the size of its main path: GPT-2 small's for adam
        n_main = PARAMS_GPT2_SMALL if rule == "adam" else PARAMS_RESNET50
        max_abs = max_rel = 0.0
        for n in sorted({PARAMS_RESNET50, RAGGED, n_main}):
            gen = torch.Generator(device="cuda").manual_seed(n)
            p = torch.randn(n, device="cuda", generator=gen)
            ours = {"p": p, "mu": torch.zeros_like(p),
                    "nu": torch.zeros_like(p)}
            plain = {k: v.clone() for k, v in ours.items()}
            for step in range(1, 4):
                g = torch.randn(n, device="cuda", generator=gen)
                s = opt._scalars(step)
                fu.flat_update_(rule, ours["p"], g, ours["mu"], ours["nu"],
                                **s)
                if rule == "sgd":
                    fu.plain_sgd_(plain["p"], g, **s)
                elif rule == "momentum":
                    fu.plain_momentum_(plain["p"], g, plain["mu"], **s)
                else:
                    fu.plain_adam_(plain["p"], g, plain["mu"], plain["nu"],
                                   **s)
            torch.cuda.synchronize()
            for k in ours:
                d = (ours[k] - plain[k]).abs()
                max_abs = max(max_abs, d.max().item())
                max_rel = max(max_rel, (d / plain[k].abs().clamp_min(
                    1e-30)).max().item())
                if not torch.allclose(ours[k], plain[k], rtol=K1_RTOL,
                                      atol=K1_ATOL):
                    fail(f"K1 {rule} disagrees with its plain version at "
                         f"n={n} ({k}): max abs {d.max().item()}")

        # bf16(0.999) is 1.0, which zeroes 1 - b2 and keeps nu at 0: the
        # bf16 check of adam takes b2 = 0.99, whose moments move
        bf16_opt = fu.fused_adam(1e-3, b2=0.99) if rule == "adam" else opt
        bf16_bad, bf16_abs = _k1_bf16_mismatches(fu, rule, bf16_opt, n_main)
        if bf16_bad:
            fail(f"K1 {rule} on bf16 groups is not bit-equal to its plain "
                 f"version: {bf16_bad}")

        n = n_main
        replaces, bytes_per, flops_per = RULES[rule]
        timed = {dtype: _k1_times(fu, rule, opt, n, dtype)
                 for dtype in (torch.float32, torch.bfloat16)}
        kernel_ms, plain_ms, library_ms = timed[torch.float32]
        bytes_ms = bytes_per * n / flops_mod.hbm_bytes_per_sec() * 1e3
        ops_ms = flops_per * n / flops_mod.H100_FP32_FLOPS * 1e3
        results[rule] = {
            "name": f"fused_update_{rule}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/fused_update.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": max_abs,
            "max_rel_err": max_rel,
            "tolerance": {"rtol": K1_RTOL, "atol": K1_ATOL},
            "n": n,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "library_call": ("torch.optim.Adam(fused=True).step"
                             if rule == "adam" else
                             "torch.optim.SGD(fused=True).step"),
            # the same rule on a bf16 group of the same length: bit-equal
            # to its plain version (checked above), half the bytes;
            # launches are the rule's main path's on bf16 groups
            "bf16": {"ms": timed[torch.bfloat16][0],
                     "plain_ms": timed[torch.bfloat16][1],
                     "library_ms": timed[torch.bfloat16][2],
                     "bound_ms": bytes_ms / 2, "bound_by": "bytes",
                     "max_abs_err": bf16_abs,
                     "tolerance": "bit-equal (torch.equal)",
                     "launches": None},
        }
    emit({"phase": "kernels", "rules": {
        r: {**{k: v[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                 "plain_ms", "library_ms", "bound_ms")},
            "bf16": v["bf16"]}
        for r, v in results.items()}})
    return results


def _k1_bf16_mismatches(fu, rule, opt, n_main) -> list:
    """K1's ``rule`` on bf16 groups against its plain version over 3
    steps, at the rule's main-path length, a ragged length and one
    element off 16-byte alignment (the scalar loop): the buffers that
    differ in any bit, and the largest absolute difference."""
    bad, max_abs = [], 0.0
    for n, off in sorted({(n_main, 0), (RAGGED, 0), (4099, 1)}):
        gen = torch.Generator(device="cuda").manual_seed(n + off)
        buf = torch.randn(n + off, device="cuda", generator=gen).bfloat16()
        ours = {"p": buf[off:], "mu": torch.zeros_like(buf[off:]),
                "nu": torch.zeros_like(buf[off:])}
        plain = {k: v.clone() for k, v in ours.items()}
        for step in range(1, 4):
            g = torch.randn(n, device="cuda", generator=gen).bfloat16()
            s = opt._scalars(step, torch.bfloat16)
            fu.flat_update_(rule, ours["p"], g, ours["mu"], ours["nu"], **s)
            args = {"sgd": (plain["p"], g),
                    "momentum": (plain["p"], g, plain["mu"]),
                    "adam": (plain["p"], g, plain["mu"], plain["nu"])}[rule]
            getattr(fu, f"plain_{rule}_")(*args, **s)
        torch.cuda.synchronize()
        bad += [(n, off, k) for k in ours
                if not torch.equal(ours[k], plain[k])]
        max_abs = max([max_abs] + [
            (ours[k].float() - plain[k].float()).abs().max().item()
            for k in ours])
    return bad, max_abs


def _k1_times(fu, rule, opt, n, dtype):
    """(kernel, plain, library) ms of ``rule`` over one group of ``n``
    parameters of ``dtype``; the library is torch.optim's fused step on
    a parameter of that dtype (timed only, the port never calls it)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    p = torch.randn(n, device="cuda", generator=gen).to(dtype)
    g = torch.randn(n, device="cuda", generator=gen).to(dtype)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    s = opt._scalars(1, dtype)
    plain_fn = {"sgd": lambda: fu.plain_sgd_(p, g, **s),
                "momentum": lambda: fu.plain_momentum_(p, g, mu, **s),
                "adam": lambda: fu.plain_adam_(p, g, mu, nu, **s)}[rule]
    kernel_ms = cuda_ms(lambda: fu.flat_update_(rule, p, g, mu, nu, **s))
    plain_ms = cuda_ms(plain_fn)
    w = torch.nn.Parameter(p.clone())
    w.grad = g.clone()
    lib = torch.optim.Adam([w], lr=1e-3, fused=True) if rule == "adam" \
        else torch.optim.SGD([w], lr=0.01, momentum=opt.momentum,
                             fused=True)
    return kernel_ms, plain_ms, cuda_ms(lib.step)


def _flash_inputs(b, h, sq, sk, d, dtype, seed, layout="bhsd"):
    """Seeded q, k, v, do as [b, h, s, d] tensors: contiguous ("bhsd"),
    views of [b, s, h, d] storage as the model passes them ("bshd"), or
    contiguous one element past an aligned address ("offset")."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        if layout == "bshd":
            return x.transpose(1, 2).contiguous().transpose(1, 2)
        if layout == "offset":
            buf = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)
            return buf[1:].view(shape).copy_(x)
        return x

    return rnd(b, h, sq, d), rnd(b, h, sk, d), rnd(b, h, sk, d), \
        rnd(b, h, sq, d)


def _causal_pairs(sq, sk, q_off, kv_off, causal) -> int:
    """(query, key) pairs the mask leaves visible, per (batch, head)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, q_off + i - kv_off + 1)) for i in range(sq))


def row_rel_err(got, want) -> Tuple[float, float]:
    """The largest and the mean ||got - want|| / (||want|| +
    FLASH_ROW_FLOOR * the mean row norm) over the rows of the last dim."""
    got, want = got.float(), want.float()
    dn, wn = (got - want).norm(dim=-1), want.norm(dim=-1)
    err = dn / (wn + FLASH_ROW_FLOOR * wn.mean()).clamp_min(1e-30)
    return err.max().item(), err.mean().item()


def _flash_case(fa, q, k, v, do, *, causal, q_off, kv_off, normalize):
    """K2 (and, for normalize=True, K3 and K4) against their plain
    versions on the same inputs: per output, the max abs error and, in
    bf16, the row error held to FLASH_BF16_ROW_LIMIT."""
    kw = dict(causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
              q_offset=q_off, kv_offset=kv_off)
    got = fa._mha_fwd(q, k, v, normalize=normalize, **kw)
    want = fa.plain_mha_fwd(q, k, v, normalize=normalize, **kw)
    pairs = dict(zip(("o", "m", "l"), zip(got, want)))
    if normalize:
        o, m, l = want
        lse = m + torch.log(l.clamp_min(1e-30))
        delta = (do.float() * o.float()).sum(-1, keepdim=True).contiguous()
        pairs["dq"] = (fa._mha_bwd_dq(q, k, v, do, lse, delta, **kw),
                       fa.plain_mha_bwd_dq(q, k, v, do, lse, delta, **kw))
        for name, g, w in zip(("dk", "dv"),
                              fa._mha_bwd_dkv(q, k, v, do, lse, delta, **kw),
                              fa.plain_mha_bwd_dkv(q, k, v, do, lse, delta,
                                                   **kw)):
            pairs[name] = (g, w)
    torch.cuda.synchronize()
    errs, row_errs = {}, {}
    for name, (g, w) in pairs.items():
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            fail(f"flash_kernels: non-finite {name} {tuple(q.shape)}")
        errs[name] = (g - w).abs().max().item()
        if q.dtype == torch.bfloat16:
            row_errs[name] = row_rel_err(g, w)
            ok = row_errs[name][0] <= FLASH_BF16_ROW_LIMIT[name] and \
                row_errs[name][1] <= FLASH_BF16_MEAN_LIMIT
        else:
            rtol, atol = FLASH_TOL[q.dtype]
            ok = torch.allclose(g, w, rtol=rtol, atol=atol)
        if not ok:
            fail(f"flash_kernels: {name} disagrees with its plain version "
                 f"at q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
                 f"causal={causal} offsets=({q_off},{kv_off}): max abs "
                 f"{errs[name]}, row error (max, mean) {row_errs.get(name)} "
                 f"(limits {FLASH_BF16_ROW_LIMIT.get(name)}, "
                 f"{FLASH_BF16_MEAN_LIMIT})")
    return errs, row_errs, got


def phase_flash_kernels(kernels, fa, flops_mod):
    """K2, K3 and K4 against their plain versions on the card: (a) the main
    path's shape in bf16, (b) float32 at ragged lengths and every head
    dim, (c) unnormalized at nonzero offsets, with a kv shard wholly in
    the future of every row; then each kernel timed at shape (a)."""
    import torch.nn.functional as F

    b, h, s, d = GPT_ATTN_SHAPE
    before = dict(kernels.flash_launches)
    # (tag, (b, h, sq, sk, d), dtype, causal, q_off, kv_off, normalize,
    # layout); bfloat16 runs the tensor-core kernels, float32 the scalar
    cases = [("a", (b, h, s, s, d), torch.bfloat16, True, 0, 0, True,
              "bshd")]
    for dtype in (torch.float32, torch.bfloat16):
        for sq, sk in ((136, 136), (192, 192), (136, 192)):
            for causal in (True, False):
                cases.append(("b", (2, 3, sq, sk, 64), dtype, causal, 0, 0,
                              True, "bhsd"))
        for hd in (16, 32, 128):
            cases.append(("b", (1, 2, 136, 136, hd), dtype, True, 0, 0,
                          True, "bhsd"))
        for q_off, kv_off in ((128, 64), (64, 200), (0, 136)):
            cases.append(("c", (2, 3, 136, 72, 64), dtype, True, q_off,
                          kv_off, False, "bhsd"))
        cases.append(("d", (2, 3, 136, 136, 64), dtype, True, 0, 0, True,
                      "offset"))
    cases.append(("c", (1, 2, 200, 136, 64), torch.bfloat16, True, 300, 0,
                  False, "bhsd"))
    per_kernel = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    worst_row = {name: 0.0 for name in FLASH_BF16_ROW_LIMIT}
    worst_mean = dict(worst_row)
    rows = []
    for i, (tag, (bb, hh, sq, sk, dd), dtype, causal, q_off, kv_off,
            normalize, layout) in enumerate(cases):
        q, k, v, do = _flash_inputs(bb, hh, sq, sk, dd, dtype, 100 + i,
                                    layout)
        errs, row_errs, got = _flash_case(fa, q, k, v, do, causal=causal,
                                          q_off=q_off, kv_off=kv_off,
                                          normalize=normalize)
        if causal and q_off + sq - 1 < kv_off:
            # every key is in the future of every row: l must be exactly
            # 0 and o finite (tests/test_flash_attention.py:88-99)
            if got[2].abs().max().item() != 0.0:
                fail("flash_kernels: a fully masked shard gave l != 0")
        for name, err in errs.items():
            key = {"o": "K2", "m": "K2", "l": "K2", "dq": "K3"}.get(name,
                                                                   "K4")
            per_kernel[key] = max(per_kernel[key], err)
        for name, (top, mean) in row_errs.items():
            worst_row[name] = max(worst_row[name], top)
            worst_mean[name] = max(worst_mean[name], mean)
        rows.append({"case": tag, "shape_bhqkd": [bb, hh, sq, sk, dd],
                     "dtype": str(dtype).rsplit(".", 1)[-1],
                     "layout": layout, "causal": causal,
                     "offsets": [q_off, kv_off], "normalize": normalize,
                     "max_abs_err": errs, "row_rel_err": row_errs})
    if dict(kernels.flash_launches) == before:
        fail("flash_kernels: the kernels were never launched")

    # timing at the main path's shape and layout
    q, k, v, do = _flash_inputs(b, h, s, s, d, torch.bfloat16, 7, "bshd")
    kw = dict(causal=True, scale=1.0 / math.sqrt(d), q_offset=0,
              kv_offset=0)
    o, m, l = fa.plain_mha_fwd(q, k, v, **kw)
    lse = m + torch.log(l.clamp_min(1e-30))
    delta = (do.float() * o.float()).sum(-1, keepdim=True).contiguous()
    bwd = (q, k, v, do, lse, delta)
    timed = {
        "K2": (lambda: fa._mha_fwd(q, k, v, **kw),
               lambda: fa.plain_mha_fwd(q, k, v, **kw)),
        "K3": (lambda: fa._mha_bwd_dq(*bwd, **kw),
               lambda: fa.plain_mha_bwd_dq(*bwd, **kw)),
        "K4": (lambda: fa._mha_bwd_dkv(*bwd, **kw),
               lambda: fa.plain_mha_bwd_dkv(*bwd, **kw)),
    }
    # the library's fused attention, timed beside the kernels only
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    library = {
        "K2": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "K3+K4": cuda_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do, retain_graph=True)),
    }
    pairs = b * h * _causal_pairs(s, s, 0, 0, True)
    elems = b * h * s * d
    rows_f32 = b * h * s * 4
    # (flops, bytes): each input read once, each output written once
    work = {"K2": (4 * d * pairs, 4 * elems * 2 + 2 * rows_f32),
            "K3": (6 * d * pairs, 4 * elems * 2 + 2 * rows_f32 + elems * 4),
            "K4": (8 * d * pairs, 4 * elems * 2 + 2 * rows_f32
                   + 2 * elems * 4)}
    outputs = {"K2": ("o", "m", "l"), "K3": ("dq",), "K4": ("dk", "dv")}
    results = {}
    for key, (kernel_fn, plain_fn) in timed.items():
        flops, nbytes = work[key]
        bytes_ms = nbytes / flops_mod.hbm_bytes_per_sec() * 1e3
        ops_ms = flops / flops_mod.H100_PEAK_FLOPS * 1e3
        name, replaces = FLASH_KERNELS[key]
        results[key] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": per_kernel[key],
            "max_bf16_row_rel_err": {n: worst_row[n] for n in outputs[key]},
            "max_bf16_mean_row_rel_err": {n: worst_mean[n]
                                          for n in outputs[key]},
            "tolerance": {
                "float32": dict(zip(("rtol", "atol"),
                                    FLASH_TOL[torch.float32])),
                "bfloat16_row": {n: FLASH_BF16_ROW_LIMIT[n]
                                 for n in outputs[key]},
                "bfloat16_mean_row": FLASH_BF16_MEAN_LIMIT,
                "bfloat16_row_floor": FLASH_ROW_FLOOR},
            "shape_bhsd": [b, h, s, d], "dtype": "bfloat16",
            "causal": True, "flops": flops, "bytes": nbytes,
            "ms": cuda_ms(kernel_fn), "plain_ms": cuda_ms(plain_fn),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library["K2"] if key == "K2"
            else library["K3+K4"],
            "library_call": (
                "F.scaled_dot_product_attention(is_causal=True) forward"
                if key == "K2" else
                "backward of F.scaled_dot_product_attention(is_causal=True),"
                " dq, dk and dv together (K3+K4's work)"),
        }
    emit({"phase": "flash_kernels", "cases": rows,
          "max_bf16_row_rel_err": worst_row,
          "max_bf16_mean_row_rel_err": worst_mean,
          "timing": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
                     for k, v in results.items()}})
    return results


# ---------------------------------------------------------------------------
# K6, K6', K7 and K8-K10: the ResNet kernel variants
# ---------------------------------------------------------------------------
def _bound(flops_mod, flops: float, nbytes: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over ``peak``."""
    bytes_ms = nbytes / flops_mod.hbm_bytes_per_sec() * 1e3
    ops_ms = flops / peak * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def _seeded(shape, dtype, seed, scale=1.0, offset=False):
    """Seeded normal values on the card; ``offset``: contiguous one
    element past an aligned address (the kernels' scalar paths)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, device="cuda", generator=gen) * scale).to(dtype)
    if not offset:
        return x
    buf = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)
    return buf[1:].view(shape).copy_(x)


def phase_elementwise_kernels(kernels, ew, flops_mod):
    """K6, K6' and K7 against their plain versions, bit for bit, on seeded
    bf16 and float32 inputs: ResNet-50's join shapes, a ragged row count,
    C = 36, an operand off 16-byte alignment, and the expanded (stride-0)
    gradient that the last block's mean hands back.  Then each kernel's
    time at [128, 56, 56, 256] bf16 beside its plain version's and its
    bound."""
    before = dict(kernels.elementwise_launches)
    cases = []
    shapes = [EW_SHAPE, (128, 112, 112, 64), (128, 7, 7, 2048),
              (3, 5, 7, 64), (2, 5, 5, 36)]
    seed = 500
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes + [("offset", (2, 5, 7, 64))]:
            offset = shape[0] == "offset"
            shape = shape[1] if offset else shape
            seed += 1
            x = _seeded(shape, dtype, seed, offset=offset)
            y = _seeded(shape, dtype, seed + 1000)
            g = _seeded(shape, dtype, seed + 2000)
            c = shape[-1]
            scale = _seeded((c,), torch.float32, seed + 3000).abs() + 0.5
            bias = _seeded((c,), torch.float32, seed + 4000)
            out = ew._residual_relu(x, y)
            pairs = {
                "K7": (out, ew.plain_residual_relu(x, y)),
                "K6'": (ew._relu_grad(out, g), ew.plain_relu_grad(out, g)),
                "K6": (ew._scale_bias_relu(x, scale, bias),
                       ew.plain_scale_bias_relu(x, scale, bias)),
            }
            torch.cuda.synchronize()
            for key, (got, want) in pairs.items():
                if got.dtype != want.dtype or not torch.equal(got, want):
                    fail(f"elementwise_kernels: {key} differs from its plain "
                         f"version at {shape} {dtype} offset={offset}: max "
                         f"abs {(got.float() - want.float()).abs().max()}")
            cases.append({"shape": list(shape), "offset": offset,
                          "dtype": str(dtype).rsplit(".", 1)[-1]})
        # the expanded gradient of x.mean((1, 2)), through both Functions
        b, h, w, c = 4, 7, 7, 64
        x = _seeded((b, h, w, c), dtype, 90).requires_grad_()
        y = _seeded((b, h, w, c), dtype, 91).requires_grad_()
        scale = (_seeded((c,), torch.float32, 92).abs() + 0.5) \
            .requires_grad_()
        bias = _seeded((c,), torch.float32, 93).requires_grad_()
        gm = _seeded((b, 1, 1, c), dtype, 94).expand(b, h, w, c)
        out = ew.residual_relu(x, y)
        out.backward(gm)
        want = ew.plain_relu_grad(out.detach(), gm)
        ok = torch.equal(x.grad, want) and torch.equal(y.grad, want)
        out = ew.scale_bias_relu(x.detach(), scale, bias)
        out.backward(gm)
        gw = ew.plain_relu_grad(out.detach(), gm).float()
        # dscale and dbias are torch sums over K6''s output
        ok = ok and torch.allclose(scale.grad, (gw * x.detach().float()).sum(
            dim=(0, 1, 2)), rtol=1e-5, atol=1e-5) and torch.allclose(
                bias.grad, gw.sum(dim=(0, 1, 2)), rtol=1e-5, atol=1e-5)
        if not ok:
            fail(f"elementwise_kernels: the expanded gradient ({dtype}) "
                 "differs from the plain versions")
        cases.append({"shape": [b, h, w, c], "expanded_gradient": True,
                      "dtype": str(dtype).rsplit(".", 1)[-1]})
    launched = {k: kernels.elementwise_launches[k] - before[k]
                for k in before}
    if not all(launched.values()):
        fail(f"elementwise_kernels: launches {launched}")

    # timing at [128, 56, 56, 256] bf16, the largest join of ResNet-50
    n = math.prod(EW_SHAPE)
    x = _seeded(EW_SHAPE, torch.bfloat16, 1)
    y = _seeded(EW_SHAPE, torch.bfloat16, 2)
    g = _seeded(EW_SHAPE, torch.bfloat16, 3)
    out = ew._residual_relu(x, y)
    c = EW_SHAPE[-1]
    scale = torch.rand(c, device="cuda") + 0.5
    bias = torch.randn(c, device="cuda")
    timed = {  # key: (kernel, plain, library or None, flops, bytes)
        "K7": (lambda: ew._residual_relu(x, y),
               lambda: ew.plain_residual_relu(x, y), None, 2 * n, 3 * 2 * n),
        "K6'": (lambda: ew._relu_grad(out, g),
                lambda: ew.plain_relu_grad(out, g),
                lambda: torch.ops.aten.threshold_backward(g, out, 0.0),
                n, 3 * 2 * n),
        "K6": (lambda: ew._scale_bias_relu(x, scale, bias),
               lambda: ew.plain_scale_bias_relu(x, scale, bias), None,
               3 * n, 2 * 2 * n + 2 * 4 * c),
    }
    results = {}
    for key, (kernel_fn, plain_fn, lib_fn, flops, nbytes) in timed.items():
        name, replaces = EW_KERNELS[key]
        bound_ms, bound_by = _bound(flops_mod, flops, nbytes,
                                    flops_mod.H100_FP32_FLOPS)
        results[key] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/elementwise.cu",
            "replaces": replaces, "launches": None, "max_abs_err": 0.0,
            "tolerance": "bit-equal (torch.equal)",
            "shape": list(EW_SHAPE), "dtype": "bfloat16",
            "flops": flops, "bytes": nbytes,
            "ms": cuda_ms(kernel_fn), "plain_ms": cuda_ms(plain_fn),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(lib_fn) if lib_fn else None,
            "library_call": "torch.ops.aten.threshold_backward(g, out, 0)"
            if lib_fn else None,
        }
    emit({"phase": "elementwise_kernels", "cases": cases,
          "launches": launched,
          "timing": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
                     for k, v in results.items()}})
    return results


def _conv_case(cb, x, w, scale, bias, mainloop=None):
    """K8, K9 and K10 against their plain versions on the same inputs:
    per output, the max abs error and, in bf16, the row error; K9's sums
    relative to the column's sum of |acc| (sum) and sum of acc^2
    (sumsq).  ``mainloop="mma_sync"`` runs bf16 on that mainloop instead
    of the plan's."""
    if mainloop is None:
        got = {"K8": cb.conv3x3_bn_relu(x, w, scale, bias),
               "K9": cb.conv3x3_stats(x, w), "K10": cb.conv3x3_plain(x, w)}
    else:
        from horovod_tpu_torch import kernels

        got = {"K8": kernels.launch_conv3x3("bn_relu", x, w, scale, bias,
                                            mainloop=mainloop),
               "K9": kernels.launch_conv3x3("stats", x, w,
                                            mainloop=mainloop),
               "K10": kernels.launch_conv3x3("plain", x, w,
                                             mainloop=mainloop)}
    want = {"K8": cb.plain_conv3x3_bn_relu(x, w, scale, bias),
            "K9": cb.plain_conv3x3_stats(x, w),
            "K10": cb.plain_conv3x3_plain(x, w)}
    torch.cuda.synchronize()
    errs, row_errs, sum_errs = {}, {}, {}
    for key in got:
        g = got[key][0] if key == "K9" else got[key]
        p = want[key][0] if key == "K9" else want[key]
        g, p = g.float(), p.float()
        if not torch.isfinite(g).all():
            fail(f"conv_kernels: non-finite {key} at {tuple(x.shape)}")
        errs[key] = (g - p).abs().max().item()
        if x.dtype == torch.bfloat16:
            row_errs[key] = row_rel_err(g, p)
            ok = row_errs[key][0] <= CONV_BF16_ROW_LIMIT and \
                row_errs[key][1] <= CONV_BF16_MEAN_LIMIT
        else:
            ok = torch.allclose(g, p, rtol=CONV_F32_RTOL,
                                atol=CONV_F32_ATOL * p.abs().max().item())
        if not ok:
            fail(f"conv_kernels: {key} disagrees with its plain version at "
                 f"x {tuple(x.shape)} w {tuple(w.shape)} {x.dtype}: max abs "
                 f"{errs[key]}, row error (max, mean) {row_errs.get(key)}")
    y_abs = want["K9"][0].float().abs().sum(dim=(0, 1, 2))
    for i, (name, norm) in enumerate((("sum", y_abs),
                                      ("sumsq", want["K9"][2]))):
        rel = ((got["K9"][i + 1] - want["K9"][i + 1]).abs()
               / norm.clamp_min(1e-30)).max().item()
        sum_errs[name] = rel
        if not rel <= CONV_SUM_RTOL:
            fail(f"conv_kernels: K9 {name} off its plain version by {rel} "
                 f"at x {tuple(x.shape)} {x.dtype}")
    return errs, row_errs, sum_errs


def phase_conv_kernels(kernels, cb, flops_mod):
    """K8, K9 and K10 against their plain versions: ResNet-50's four
    stride-1 3x3 shapes in bf16 on the mainloop the plan names (TMA +
    wgmma, checked by its counts) and on mma.sync, and in float32; then
    small float32, rectangular, odd-H/W, C = 24, 3-channel and misaligned
    cases (the last two take mma.sync).  Then each kernel timed at the
    four shapes on both bf16 mainloops, beside its plain version, its
    bound and the library's conv (``F.conv2d`` on channels-last bf16: the
    conv alone)."""
    import torch.nn.functional as F

    before = dict(kernels.conv_bn_launches)
    # (x shape, cout, dtype, offset, mainloop forced, mainloop expected)
    resnet = [((128, s, s, c), c) for s, c, _ in CONV_SHAPES]
    cases = [(shape, c, torch.bfloat16, False, None, "wgmma")
             for shape, c in resnet]
    cases += [(shape, c, torch.bfloat16, False, "mma_sync", "mma_sync")
              for shape, c in resnet]
    cases += [(shape, c, torch.float32, False, None, "f32")
              for shape, c in resnet]
    cases += [((2, 16, 16, 64), 64, torch.float32, False, None, "f32"),
              ((3, 8, 8, 8), 24, torch.float32, False, None, "f32"),
              ((3, 8, 8, 8), 24, torch.bfloat16, False, None, "wgmma"),
              ((2, 9, 7, 24), 24, torch.float32, False, None, "f32"),
              ((2, 9, 7, 24), 24, torch.bfloat16, False, None, "wgmma"),
              ((2, 6, 10, 24), 40, torch.bfloat16, False, None, "wgmma"),
              ((2, 5, 7, 3), 16, torch.bfloat16, False, None, "mma_sync"),
              ((2, 5, 7, 16), 16, torch.bfloat16, True, None, "mma_sync")]
    rows, worst = [], {"K8": 0.0, "K9": 0.0, "K10": 0.0}
    worst_row = {"K8": [0.0, 0.0], "K9": [0.0, 0.0], "K10": [0.0, 0.0]}
    worst_sum = {"sum": 0.0, "sumsq": 0.0}
    for i, (shape, cout, dtype, offset, forced, loop) in enumerate(cases):
        cin = shape[3]
        x = _seeded(shape, dtype, 700 + i, offset=offset)
        w = _seeded((3, 3, cin, cout), dtype, 800 + i,
                    scale=(9 * cin) ** -0.5, offset=offset)
        scale = torch.rand(cout, device="cuda") + 0.5
        bias = torch.randn(cout, device="cuda") * 0.1
        counted = dict(kernels.conv_bn_launches)
        errs, row_errs, sum_errs = _conv_case(cb, x, w, scale, bias, forced)
        took = {k: v - counted[k] for k, v in
                kernels.conv_bn_launches.items() if v != counted[k]}
        if took != {f"{e}.{loop}": 1 for e in ("bn_relu", "stats", "plain")}:
            fail(f"conv_kernels: x {shape} -> {cout} {dtype} ran {took}, "
                 f"want the {loop} mainloop")
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
        for k, (top, mean) in row_errs.items():
            worst_row[k] = [max(worst_row[k][0], top),
                            max(worst_row[k][1], mean)]
        for k, v in sum_errs.items():
            worst_sum[k] = max(worst_sum[k], v)
        rows.append({"x": list(shape), "cout": cout, "offset": offset,
                     "dtype": str(dtype).rsplit(".", 1)[-1],
                     "mainloop": loop,
                     "max_abs_err": errs, "row_rel_err": row_errs,
                     "k9_sum_rel_err": sum_errs})
        del x, w
    by_loop = {k: v - before[k] for k, v in kernels.conv_bn_launches.items()}
    launched = kernels.launch_totals(by_loop)
    if not all(launched.values()):
        fail(f"conv_kernels: launches {launched}")

    timing = {"K8": {}, "K9": {}, "K10": {}}
    for s, c, _ in CONV_SHAPES:
        x = _seeded((128, s, s, c), torch.bfloat16, 1)
        w = _seeded((3, 3, c, c), torch.bfloat16, 2, scale=(9 * c) ** -0.5)
        scale = torch.rand(c, device="cuda") + 0.5
        bias = torch.randn(c, device="cuda") * 0.1
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        library_ms = cuda_ms(lambda: F.conv2d(xl, wl, padding=1))
        m = 128 * s * s
        flops = 2 * m * c * 9 * c
        io = 2 * m * c * 2 + 9 * c * c * 2  # x and y bf16, w
        plan = kernels.conv3x3_plan(tuple(x.shape), c, x.dtype,
                                    x.data_ptr(), w.data_ptr(),
                                    *kernels.wgmma_card(x.device.index))
        fns = {"K8": ("bn_relu", (scale, bias),
                      lambda: cb.plain_conv3x3_bn_relu(x, w, scale, bias),
                      io + 2 * 4 * c),
               "K9": ("stats", (), lambda: cb.plain_conv3x3_stats(x, w),
                      io + 2 * 4 * c),
               "K10": ("plain", (), lambda: cb.plain_conv3x3_plain(x, w),
                       io)}
        for key, (kind, vecs, plain_fn, nbytes) in fns.items():
            bound_ms, bound_by = _bound(flops_mod, flops, nbytes,
                                        flops_mod.H100_PEAK_FLOPS)
            timing[key][f"{s}x{s}x{c}"] = {
                "ms": cuda_ms(lambda: kernels.launch_conv3x3(
                    kind, x, w, *vecs)),
                "mma_sync_ms": cuda_ms(lambda: kernels.launch_conv3x3(
                    kind, x, w, *vecs, mainloop="mma_sync")),
                "plain_ms": cuda_ms(plain_fn),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "flops": flops, "bytes": nbytes,
                "mainloop": plan.mainloop, "tile_n": plan.tile_n,
                "blocks": plan.blocks}
    results = {}
    head = f"{CONV_SHAPES[0][0]}x{CONV_SHAPES[0][0]}x{CONV_SHAPES[0][1]}"
    for key, (name, replaces) in CONV_KERNELS.items():
        t = timing[key]
        results[key] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/conv_bn.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": worst[key],
            "max_bf16_row_rel_err": worst_row[key],
            **({"max_k9_sum_rel_err": worst_sum} if key == "K9" else {}),
            "tolerance": {"bfloat16_row": CONV_BF16_ROW_LIMIT,
                          "bfloat16_mean_row": CONV_BF16_MEAN_LIMIT,
                          "float32": {"rtol": CONV_F32_RTOL,
                                      "atol_of_max": CONV_F32_ATOL},
                          **({"sums_rtol": CONV_SUM_RTOL}
                             if key == "K9" else {})},
            "shape": f"[128, 56, 56, 64] -> 64 bf16 ({head})",
            **{f: t[head][f] for f in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "mma_sync_ms")},
            "library_call": "F.conv2d on channels-last bf16 (the conv "
                            "alone, no epilogue)",
            "by_shape": t,
            "ms_per_resnet50_step": sum(t[f"{s}x{s}x{c}"]["ms"] * n
                                        for s, c, n in CONV_SHAPES),
            "mma_sync_ms_per_resnet50_step": sum(
                t[f"{s}x{s}x{c}"]["mma_sync_ms"] * n
                for s, c, n in CONV_SHAPES),
        }
    emit({"phase": "conv_kernels", "cases": rows, "launches": launched,
          "launches_by_mainloop": by_loop, "timing": timing})
    return results


def _variant_counts(model) -> dict:
    """Launches of K6, K6', K7, K9 and K10 one train step of ``model``
    makes, and of K8 one eval forward makes, from its modules."""
    from horovod_tpu_torch.models.resnet import (
        BatchNormReLU, PallasConvBN3x3, _Block)

    mods = list(model.modules())
    bnr = sum(isinstance(m, BatchNormReLU) for m in mods)
    fused = sum(isinstance(m, PallasConvBN3x3) for m in mods)
    blocks = sum(isinstance(m, _Block) for m in mods)
    return {"scale_bias_relu": bnr, "relu_grad": bnr + blocks,
            "residual_relu": blocks, "stats": fused, "plain": fused,
            "bn_relu": fused}


def _counts(kernels) -> dict:
    return {**kernels.elementwise_launches,
            **kernels.launch_totals(kernels.conv_bn_launches)}


def _loops(kernels) -> dict:
    """The K8-K10 launches by mainloop that were made (``"stats.wgmma"``
    ...)."""
    return {k: v for k, v in kernels.conv_bn_launches.items() if v}


def _k1(kernels, rule: str) -> dict:
    """K1's launches of ``rule`` by parameter-group type."""
    return {d: kernels.fused_update_launches[f"{rule}.{d}"]
            for d in kernels.K1_DTYPES}


def phase_variants_parity(htt, kernels):
    """A narrow ResNet-18 and ResNet-50 with all three options, trained 2
    steps in float32 from the same weights on the card (K6-K10, K1) and on
    the CPU (their plain versions), TF32 off; then one eval forward (K8)
    of each, the logits compared."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet18, ResNet50

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    models = []
    try:
        for name, cls in (("ResNet18", ResNet18), ("ResNet50", ResNet50)):
            base = cls(num_classes=10, num_filters=8, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(1),
                       **VARIANTS)
            gen = torch.Generator().manual_seed(2)
            x = torch.rand((8, 64, 64, 3), generator=gen)
            y = torch.randint(0, 10, (8,), generator=gen)
            runs = {}
            for dev in ("cuda", "cpu"):
                model = copy.deepcopy(base)
                opt = htt.fused_sgd(0.01, momentum=0.9)
                step = htt.make_train_step(
                    apply_fn=model, loss_fn=F.cross_entropy, optimizer=opt,
                    has_batch_stats=True, loss_fetch_steps=0)
                state = htt.init_train_state(model, opt, has_batch_stats=True,
                                             device=dev)
                reset_counts(kernels)
                losses = []
                for _ in range(2):
                    state, loss = step(state, x.to(dev), y.to(dev))
                    losses.append(loss.item())
                train_counts = _counts(kernels)
                model.eval()
                reset_counts(kernels)
                with torch.no_grad():
                    logits = model(x.to(dev)).cpu()
                runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                                      {**state.params,
                                       **state.model_state}.items()},
                             logits, train_counts, _counts(kernels))
            (l_gpu, t_gpu, z_gpu, n_train, n_eval), (l_cpu, t_cpu, z_cpu,
                                                      n_cpu, _) = \
                runs["cuda"], runs["cpu"]
            want = _variant_counts(base)
            want_train = {k: (0 if k == "bn_relu" else 2 * v)
                          for k, v in want.items()}
            want_eval = {k: (0 if k in ("stats", "plain", "relu_grad") else v)
                         for k, v in want.items()}
            if n_train != want_train or n_eval != want_eval or \
                    any(n_cpu.values()):
                fail(f"variants_parity: {name} launches train {n_train} "
                     f"(want {want_train}), eval {n_eval} (want "
                     f"{want_eval}), CPU {n_cpu}")
            worst = max((t_gpu[k] - t_cpu[k]).abs().max().item()
                        for k in t_cpu)
            if not all(math.isfinite(v) for v in l_gpu) or any(
                    abs(a - b) > PARITY_RTOL * abs(b) + PARITY_ATOL
                    for a, b in zip(l_gpu, l_cpu)):
                fail(f"variants_parity: {name} losses differ, card {l_gpu} "
                     f"vs CPU {l_cpu}")
            for k in t_cpu:
                if not torch.allclose(t_gpu[k], t_cpu[k], rtol=PARITY_RTOL,
                                      atol=PARITY_ATOL):
                    fail(f"variants_parity: {name} {k} differs by "
                         f"{(t_gpu[k] - t_cpu[k]).abs().max().item()}")
            if not torch.allclose(z_gpu, z_cpu, rtol=PARITY_RTOL,
                                  atol=PARITY_ATOL):
                fail(f"variants_parity: {name} eval logits differ by "
                     f"{(z_gpu - z_cpu).abs().max().item()}")
            models.append({
                "model": f"{name}(num_filters=8, all options) 64x64 b8",
                "steps": 2, "loss_card": l_gpu, "loss_cpu": l_cpu,
                "max_state_abs_err": worst,
                "max_eval_logit_abs_err": (z_gpu - z_cpu).abs().max().item(),
                "card_launches_train": n_train, "card_launches_eval": n_eval})
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    emit({"phase": "variants_parity", "options": VARIANTS, "models": models,
          "tolerance": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL},
          "tf32": False})


def phase_variants_main_path(kernels, flops_mod, card, default_img_sec):
    """``examples.synthetic_benchmark.run`` with all three options:
    ResNet-50, 224x224, batch 128, bf16, fused momentum, world size 1 over
    NCCL.  Checks a finite loss, the kernels' launches per step, one K1
    launch per step and one gradient all_reduce per fusion bucket per
    step; then one eval forward of a batch (K8).  Returns the launches."""
    import torch.distributed as dist

    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops.fusion import FusionPlan

    argv = ["--model", "ResNet50", "--image-size", "224", "--batch-size",
            "128", "--dtype", "bfloat16", "--fused-optimizer",
            "--num-warmup-batches", "2", "--num-batches-per-iter", "5",
            "--num-iters", "3", "--norm-act", "pallas", "--residual-join",
            "pallas", "--conv-bn", "pallas"]
    steps = 2 + 5 * 3
    with torch.device("meta"):
        meta = ResNet50(**VARIANTS)
        buckets = FusionPlan(list(canonical_params(meta).values())
                             ).num_buckets()
        structural = _variant_counts(meta)
    if {k: structural[k] for k in VARIANT_STEP_LAUNCHES} != \
            VARIANT_STEP_LAUNCHES:
        fail(f"variants_main_path: the model has {structural}, want "
             f"{VARIANT_STEP_LAUNCHES} a step")
    calls = [0]
    all_reduce = dist.all_reduce

    def counting_all_reduce(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    dist.all_reduce = counting_all_reduce
    try:
        t0 = time.perf_counter()
        result = sb.run(sb.parse_args(argv))
        wall = time.perf_counter() - t0
    finally:
        dist.all_reduce = all_reduce
    k1 = kernels.launch_totals(kernels.fused_update_launches)
    launches = {**_counts(kernels), "K1_momentum": k1["momentum"],
                "K1_other": k1["sgd"] + k1["adam"],
                "flash": sum(kernels.flash_launches.values())}
    by_loop = _loops(kernels)
    peak = torch.cuda.max_memory_allocated()
    want = {**{k: v * steps for k, v in VARIANT_STEP_LAUNCHES.items()},
            "bn_relu": 0, "K1_momentum": steps, "K1_other": 0, "flash": 0}
    if not math.isfinite(result["final_loss"]):
        fail(f"variants_main_path: final loss {result['final_loss']}")
    if launches != want:
        fail(f"variants_main_path: launches {launches} over {steps} steps, "
             f"want {want}")
    # every K9 and K10 launch of the step on the TMA + wgmma mainloop
    want_loop = {"stats.wgmma": want["stats"], "plain.wgmma": want["plain"]}
    if by_loop != want_loop:
        fail(f"variants_main_path: K8-K10 mainloops {by_loop}, want "
             f"{want_loop}")
    grad_calls_per_step = calls[0] / steps - 1
    if grad_calls_per_step != buckets:
        fail(f"variants_main_path: {calls[0]} all_reduce calls over {steps} "
             f"steps, want {buckets} buckets + 1 loss per step")

    # the eval forward of one batch: K8 in every fused block
    device = torch.device("cuda", torch.cuda.current_device())
    model = ResNet50(generator=torch.Generator().manual_seed(0),
                     **VARIANTS).to(device,
                                    memory_format=torch.channels_last).eval()
    x = torch.rand((128, 224, 224, 3), device=device,
                   generator=torch.Generator(device=device).manual_seed(42))
    reset_counts(kernels)
    with torch.no_grad():
        logits = model(x)
    torch.cuda.synchronize()
    eval_launches = _counts(kernels)
    eval_by_loop = _loops(kernels)
    want_eval = {"scale_bias_relu": VARIANT_STEP_LAUNCHES["scale_bias_relu"],
                 "relu_grad": 0,
                 "residual_relu": VARIANT_STEP_LAUNCHES["residual_relu"],
                 "bn_relu": structural["bn_relu"], "stats": 0, "plain": 0}
    if eval_launches != want_eval or tuple(logits.shape) != (128, 1000) or \
            not torch.isfinite(logits).all() or \
            eval_by_loop != {"bn_relu.wgmma": want_eval["bn_relu"]}:
        fail(f"variants_main_path: eval forward launches {eval_launches} "
             f"(want {want_eval}) on {eval_by_loop}, logits "
             f"{tuple(logits.shape)} finite="
             f"{bool(torch.isfinite(logits).all())}")
    del model, logits
    emit({"phase": "variants_main_path", "model": "ResNet50", "options":
          VARIANTS, "image_size": 224, "batch_per_chip": 128,
          "dtype": "bfloat16", "optimizer": "fused momentum (K1)",
          "world_size": result["size"], "steps": steps,
          "launches": launches, "launches_per_step": {
              k: v / steps for k, v in launches.items()},
          "conv_launches_by_mainloop": by_loop,
          "eval_forward_launches": eval_launches,
          "eval_conv_launches_by_mainloop": eval_by_loop,
          "fusion_buckets": buckets,
          "grad_allreduce_per_step": grad_calls_per_step,
          "img_sec_per_chip": result["img_sec_per_chip"],
          "img_sec_conf": result["conf"],
          "default_path_img_sec_per_chip": default_img_sec,
          "mfu": flops_mod.image_model_mfu(result["img_sec_per_chip"]),
          "final_loss": result["final_loss"],
          "max_memory_allocated_bytes": peak, "wall_s": wall, "card": card})
    return {**{k: launches[k] for k in VARIANT_STEP_LAUNCHES},
            "bn_relu": eval_launches["bn_relu"]}, {**by_loop, **eval_by_loop}


def phase_variants_profile(htt):
    """3 variants main-path steps (ResNet-50 with all three options,
    224x224, batch 128, bf16, fused momentum) under torch.profiler:
    device time per step by kind (``K6-K7``, ``K8-K10`` for the port's
    kernels) and the device's idle share."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50

    device = htt.device()
    gen = torch.Generator(device=device).manual_seed(42)
    x = torch.rand((128, 224, 224, 3), generator=gen, device=device)
    y = torch.randint(0, 1000, (128,), generator=gen, device=device)
    model = ResNet50(generator=torch.Generator().manual_seed(0),
                     **VARIANTS).to(device, memory_format=torch.channels_last)
    opt = htt.fused_sgd(0.01, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, has_batch_stats=True,
                               loss_fetch_steps=0)
    state = htt.init_train_state(model, opt, has_batch_stats=True)
    steps = 3
    wall_ms, spans, loss = _profile_steps(step, state, (x, y), steps)
    ported = {}
    for start, end, name in spans:
        kind = _kernel_kind(name)
        if kind in ("K6-K7", "K8-K10"):
            n, ms = ported.get(name, (0, 0.0))
            ported[name] = (n + 1, ms + (end - start) / 1e3)
    emit({"phase": "variants_profile", "model": "ResNet50", "options":
          VARIANTS, "steps": steps, "wall_ms_per_step": wall_ms,
          **device_breakdown(spans, steps),
          "ported_kernels": {n[:80]: {"launches_per_step": k / steps,
                                      "ms_per_launch": ms / k}
                             for n, (k, ms) in ported.items()},
          "final_loss": loss})
    del model, state, step


def phase_parity(htt):
    """A narrow ResNet-18 trained 2 steps on the card and on the CPU from
    the same weights and batch."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet18

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(2)
        x = torch.rand((8, 64, 64, 3), generator=gen)
        y = torch.randint(0, 10, (8,), generator=gen)
        runs = {}
        for dev in ("cuda", "cpu"):
            model = copy.deepcopy(base)
            opt = htt.fused_sgd(0.01, momentum=0.9)
            step = htt.make_train_step(apply_fn=model,
                                       loss_fn=F.cross_entropy,
                                       optimizer=opt, has_batch_stats=True,
                                       loss_fetch_steps=0)
            state = htt.init_train_state(model, opt, has_batch_stats=True,
                                         device=dev)
            losses = []
            for _ in range(2):
                state, loss = step(state, x.to(dev), y.to(dev))
                losses.append(loss.item())
            runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                                  {**state.params,
                                   **state.model_state}.items()})
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    (l_gpu, t_gpu), (l_cpu, t_cpu) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(l_gpu, l_cpu))
    worst = max((t_gpu[k] - t_cpu[k]).abs().max().item() for k in t_cpu)
    if not all(math.isfinite(v) for v in l_gpu):
        fail(f"parity: non-finite loss on the card {l_gpu}")
    if any(abs(a - b) > PARITY_RTOL * abs(b) + PARITY_ATOL
           for a, b in zip(l_gpu, l_cpu)):
        fail(f"parity: losses differ, card {l_gpu} vs CPU {l_cpu}")
    for k in t_cpu:
        if not torch.allclose(t_gpu[k], t_cpu[k], rtol=PARITY_RTOL,
                              atol=PARITY_ATOL):
            fail(f"parity: {k} differs by "
                 f"{(t_gpu[k] - t_cpu[k]).abs().max().item()}")
    emit({"phase": "parity", "model": "ResNet18(num_filters=8) 64x64 b8",
          "steps": 2, "loss_card": l_gpu, "loss_cpu": l_cpu,
          "max_loss_err": loss_err, "max_state_abs_err": worst,
          "tolerance": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL},
          "tf32": False})


def phase_main_path(kernels, flops_mod, card):
    import torch.distributed as dist

    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops.fusion import FusionPlan

    argv = ["--model", "ResNet50", "--image-size", "224", "--batch-size",
            "128", "--dtype", "bfloat16", "--fused-optimizer",
            "--num-warmup-batches", "2", "--num-batches-per-iter", "5",
            "--num-iters", "3"]
    steps = 2 + 5 * 3
    with torch.device("meta"):
        buckets = FusionPlan(list(canonical_params(
            ResNet50()).values())).num_buckets()

    calls = [0]
    all_reduce = dist.all_reduce

    def counting_all_reduce(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    dist.all_reduce = counting_all_reduce
    try:
        t0 = time.perf_counter()
        result = sb.run(sb.parse_args(argv))
        wall = time.perf_counter() - t0
    finally:
        dist.all_reduce = all_reduce
    launches = kernels.launch_totals(kernels.fused_update_launches)
    k1 = _k1(kernels, "momentum")

    if not math.isfinite(result["final_loss"]):
        fail(f"main path: final loss {result['final_loss']}")
    if launches["momentum"] != steps or launches["sgd"] or launches["adam"]:
        fail(f"main path: K1 launches {kernels.fused_update_launches}, want "
             f"{steps} momentum")
    if any(kernels.flash_launches.values()):
        fail(f"main path: ResNet-50 launched {kernels.flash_launches}")
    # one all_reduce per gradient bucket, plus one for the reported loss
    grad_calls_per_step = calls[0] / steps - 1
    if grad_calls_per_step != buckets:
        fail(f"main path: {calls[0]} all_reduce calls over {steps} steps, "
             f"want {buckets} buckets + 1 loss per step")
    emit({"phase": "main_path", "model": "ResNet50", "image_size": 224,
          "batch_per_chip": 128, "dtype": "bfloat16", "optimizer":
          "fused momentum (K1)", "world_size": result["size"],
          "steps": steps, "k1_launches": k1,
          "fusion_buckets": buckets,
          "grad_allreduce_per_step": grad_calls_per_step,
          "img_sec_per_chip": result["img_sec_per_chip"],
          "img_sec_conf": result["conf"],
          "mfu": flops_mod.image_model_mfu(result["img_sec_per_chip"]),
          "peak_flops": flops_mod.peak_flops(),
          "final_loss": result["final_loss"],
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "wall_s": wall, "card": card})
    return k1, result["img_sec_per_chip"]


def _kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name, for the step breakdown:
    the port's kernels (K1; K2-K4 as ``flash``, the attention core;
    K6-K7, the elementwise joins; K8-K10, the fused 3x3 conv, whose names
    would otherwise read as the library's conv or BatchNorm), then the
    library's convolutions apart from its matrix products (the QKV,
    output, MLP and head projections on the GPT path)."""
    low = name.lower()
    if "hvd_conv" in low:  # hvd_conv3x3_*_kernel, hvd_conv_stats_reduce_*
        return "K8-K10"
    if any(k in low for k in ("hvd_residual_relu", "hvd_relu_grad",
                              "hvd_scale_bias_relu")):
        return "K6-K7"
    if any(k in low for k in ("momentum_kernel", "sgd_kernel",
                              "adam_kernel")):
        return "K1"
    if "hvdflashargs" in low:  # K2-K4 all take the one argument block
        return "flash"
    if "nccl" in low:
        return "nccl"
    if "bn_" in low or "batch_norm" in low or "batchnorm" in low:
        return "batchnorm"
    if any(k in low for k in ("conv", "wgrad", "dgrad", "fprop",
                              "nchwtonhwc", "nhwctonchw")):
        return "conv"
    if any(k in low for k in ("xmma", "gemm", "gemv", "cutlass", "nvjet")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    if "embedding" in low or "index" in low:
        return "embedding_index"
    if any(k in low for k in ("memcpy", "memset", "copy", "catarray")):
        return "copy"
    if "reduce" in low:
        return "reduction"
    return "elementwise_other"


def device_breakdown(spans, steps: int) -> dict:
    """Per-step device time from kernel ``(start_us, end_us, name)``
    spans: by kind, the busiest kernels, and the idle share of the span
    from the first kernel's start to the last one's end (kernels that
    overlap on two streams count once)."""
    spans = sorted(spans)
    by_kind, by_name = {}, {}
    busy_us = 0.0
    cur_start, cur_end = spans[0][0], spans[0][1]
    for start, end, name in spans:
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + end - start
        by_name[name] = by_name.get(name, 0.0) + end - start
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    span_us = max(end for _, end, _ in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_span_ms_per_step": span_us / 1e3 / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "idle_share": 1.0 - busy_us / span_us,
            "kernels_per_step": len(spans) / steps,
            "ms_per_step_by_kind": {
                k: v / 1e3 / steps
                for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [[n[:100], v / 1e3 / steps]
                                        for n, v in top]}


def reset_counts(kernels) -> None:
    """Every kernel's launch count to 0."""
    for counts in (kernels.fused_update_launches, kernels.flash_launches,
                   kernels.elementwise_launches, kernels.conv_bn_launches):
        for k in counts:
            counts[k] = 0


def _gpt_parity_run(htt, kernels, seed, lr, steps):
    """One seed of gpt_parity: card and CPU runs, the differences and the
    key bias's gradient on the card at the initial weights."""
    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.models import gpt_tiny, next_token_loss

    base = gpt_tiny(vocab_size=256, hidden_dim=64, num_layers=2,
                    num_heads=4, dtype=torch.float32,
                    generator=torch.Generator().manual_seed(seed))
    ids = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 256, size=(2, 136)))
    model = copy.deepcopy(base).cuda()
    next_token_loss(model(ids.cuda()), ids.cuda()).backward()
    grads = {k: t.grad.abs().max().item()
             for k, t in canonical_params(model).items()}
    runs = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base)
        opt = htt.fused_adam(lr)
        step = htt.make_train_step(apply_fn=model, loss_fn=next_token_loss,
                                   optimizer=opt, loss_fetch_steps=0)
        state = htt.init_train_state(model, opt, device=dev)
        reset_counts(kernels)
        losses = []
        for _ in range(steps):
            state, loss = step(state, ids.to(dev), ids.to(dev))
            losses.append(loss.item())
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                              state.params.items()},
                     dict(kernels.flash_launches),
                     kernels.launch_totals(
                         kernels.fused_update_launches)["adam"])
    (l_gpu, p_gpu, flash, adam), (l_cpu, p_cpu, _, _) = runs["cuda"], \
        runs["cpu"]
    if flash != {"fwd": 2 * steps, "bwd_dq": 2 * steps,
                 "bwd_dkv": 2 * steps} or adam != steps:
        fail(f"gpt_parity: card launches K2-K4 {flash}, K1 adam {adam}")
    if not all(math.isfinite(v) for v in l_gpu) or any(
            abs(a - b) > GPT_LOSS_RTOL * abs(b) for a, b in zip(l_gpu, l_cpu)):
        fail(f"gpt_parity: seed {seed}: losses differ, card {l_gpu} vs CPU "
             f"{l_cpu}")
    keyb = [k for k in p_cpu if k.endswith(KEY_BIAS)]
    diff = {part: torch.cat([(p_gpu[k] - p_cpu[k]).abs().reshape(-1)
                             for k in p_cpu if (k in keyb) == (part == "key")])
            for part in ("key", "other")}
    return {"seed": seed, "loss_card": l_gpu, "loss_cpu": l_cpu,
            "max_loss_rel_err": max(abs(a - b) / abs(b)
                                    for a, b in zip(l_gpu, l_cpu)),
            "max_param_abs_err": diff["other"].max().item(),
            "params_beyond_atol": int((diff["other"] > GPT_PARAM_ATOL)
                                      .sum().item()),
            "n_params": len(diff["other"]),
            "key_bias_max_abs_err": diff["key"].max().item(),
            "n_key_bias": len(diff["key"]),
            "key_bias_grad_max": max(grads[k] for k in keyb),
            "other_grad_max": max(v for k, v in grads.items()
                                  if k not in keyb),
            "card_launches": {**flash, "adam": adam}}


def phase_gpt_parity(htt, kernels):
    """A float32 GPT of gpt_tiny's shape (2 layers, hidden 64, 4 heads,
    vocab 256, seq 136) trained 2 steps with fused Adam from the same
    weights and ids on the card (K1-K4) and on the CPU (plain), from each
    of GPT_PARITY_SEEDS."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lr, steps = 1e-3, 2
    bound = GPT_FLIP_BOUND * lr * steps
    try:
        seeds = [_gpt_parity_run(htt, kernels, seed, lr, steps)
                 for seed in GPT_PARITY_SEEDS]
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    for r in seeds:
        if r["max_param_abs_err"] > bound or r["key_bias_max_abs_err"] > \
                bound or r["params_beyond_atol"] > GPT_FLIP_SHARE * \
                r["n_params"]:
            fail(f"gpt_parity: seed {r['seed']}: parameters differ by up to "
                 f"{r['max_param_abs_err']} (key bias "
                 f"{r['key_bias_max_abs_err']}), {r['params_beyond_atol']} "
                 f"of {r['n_params']} beyond {GPT_PARAM_ATOL}")
    emit({"phase": "gpt_parity", "model": "GPT(vocab 256, hidden 64, 2 "
          "layers, 4 heads, mlp 256) float32, b2 s136, fused_adam(1e-3)",
          "steps": steps, "seeds": seeds,
          "tolerance": {"loss_rtol": GPT_LOSS_RTOL,
                        "param_atol": GPT_PARAM_ATOL,
                        "share_beyond_atol": GPT_FLIP_SHARE,
                        "param_bound": bound,
                        "exempt_from_atol": f"*/{KEY_BIAS}"},
          "tf32": False})


def phase_gpt_bf16(kernels, fa):
    """A bf16 GPT with GPT-2 small's head dim (2 layers, hidden 128, 2
    heads, vocab 1024, b2 s320: five kv tiles, the last ragged), one
    forward and backward on the card through K2-K4 and through their
    plain versions from the same weights and ids: the loss and each
    parameter's gradient, in norm, from each of GPT_PARITY_SEEDS."""
    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.models import gpt_tiny, next_token_loss

    plain_fn = (lambda q, k, v, mask:
                fa.plain_flash_attention(q, k, v, causal=True))
    cfg = dict(vocab_size=1024, hidden_dim=128, num_layers=2, num_heads=2,
               mlp_dim=256, max_len=512, dtype=torch.bfloat16)
    seeds = []
    for seed in GPT_PARITY_SEEDS:
        ids = torch.from_numpy(np.random.default_rng(seed + 1).integers(
            0, 1024, size=(2, 320))).cuda()
        out = {}
        for name, attn in (("kernels", None), ("plain", plain_fn)):
            model = gpt_tiny(attention_fn=attn, generator=torch.Generator()
                             .manual_seed(seed), **cfg).cuda()
            reset_counts(kernels)
            loss = next_token_loss(model(ids), ids)
            loss.backward()
            torch.cuda.synchronize()
            out[name] = (loss.item(), {k: t.grad for k, t in
                                       canonical_params(model).items()},
                         dict(kernels.flash_launches))
        (l_k, g_k, n_k), (l_p, g_p, n_p) = out["kernels"], out["plain"]
        if n_k != {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2} or any(n_p.values()):
            fail(f"gpt_bf16: launches {n_k} through the kernels, {n_p} "
                 "through the plain versions")
        rel = {k: ((g_k[k].float() - g_p[k].float()).norm()
                   / g_p[k].float().norm().clamp_min(1e-30)).item()
               for k in g_p if not k.endswith(KEY_BIAS)}
        worst = max(rel, key=rel.get)
        seeds.append({
            "seed": seed, "loss_kernels": l_k, "loss_plain": l_p,
            "loss_rel_err": abs(l_k - l_p) / abs(l_p),
            "max_grad_rel_err": rel[worst], "worst_param": worst,
            "key_bias_grad_norm": {
                n: sum(g[k].float().norm().item() for k in g
                       if k.endswith(KEY_BIAS)) for n, g in
                (("kernels", g_k), ("plain", g_p))}})
        if not math.isfinite(l_k) or \
                seeds[-1]["loss_rel_err"] > GPT_BF16_LOSS_RTOL or \
                rel[worst] > GPT_BF16_GRAD_RTOL:
            fail(f"gpt_bf16: {seeds[-1]}")
    emit({"phase": "gpt_bf16", "model": "GPT(vocab 1024, hidden 128, 2 "
          "layers, 2 heads of 64, mlp 256) bf16, b2 s320, K2-K4 against "
          "plain_flash_attention", "seeds": seeds,
          "tolerance": {"loss_rtol": GPT_BF16_LOSS_RTOL,
                        "grad_norm_rtol": GPT_BF16_GRAD_RTOL,
                        "exempt": f"*/{KEY_BIAS}"}})


def _gpt2_buckets() -> int:
    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.models import gpt2_small
    from horovod_tpu_torch.ops.fusion import FusionPlan

    with torch.device("meta"):
        return FusionPlan(list(canonical_params(
            gpt2_small()).values())).num_buckets()


def phase_gpt_main_path(htt, kernels, card):
    """``examples.gpt_synthetic_benchmark.run`` at its defaults: GPT-2
    small, batch 4, seq 1024, bf16, flash attention (K2-K4), fused Adam
    (K1), world size 1 over NCCL."""
    import torch.distributed as dist

    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    args = gb.parse_args([])
    steps = args.num_warmup_batches + \
        args.num_batches_per_iter * args.num_iters
    layers = 12
    buckets = _gpt2_buckets()
    calls = [0]
    all_reduce = dist.all_reduce

    def counting_all_reduce(*a, **kw):
        calls[0] += 1
        return all_reduce(*a, **kw)

    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    dist.all_reduce = counting_all_reduce
    try:
        t0 = time.perf_counter()
        result = gb.run(args)
        wall = time.perf_counter() - t0
    finally:
        dist.all_reduce = all_reduce
    flash = dict(kernels.flash_launches)
    k1 = kernels.launch_totals(kernels.fused_update_launches)
    adam = _k1(kernels, "adam")

    if not math.isfinite(result["final_loss"]):
        fail(f"gpt_main_path: final loss {result['final_loss']}")
    if flash != {k: layers * steps for k in flash}:
        fail(f"gpt_main_path: K2-K4 launches {flash}, want "
             f"{layers * steps} each")
    if k1 != {"sgd": 0, "momentum": 0, "adam": steps}:
        fail(f"gpt_main_path: K1 launches {k1}, want {steps} adam")
    grad_calls_per_step = calls[0] / steps - 1
    if grad_calls_per_step != buckets:
        fail(f"gpt_main_path: {calls[0]} all_reduce calls over {steps} "
             f"steps, want {buckets} buckets + 1 loss per step")
    emit({"phase": "gpt_main_path", "model": "gpt2_small",
          "batch_per_chip": args.batch_size, "seq_len": args.seq_len,
          "dtype": args.dtype, "attn": args.attn,
          "optimizer": "fused_adam(1e-4) (K1 adam)",
          "world_size": htt.size(), "steps": steps,
          "k2_k4_launches": flash,
          "k1_launches": dict(kernels.fused_update_launches),
          "fusion_buckets": buckets,
          "grad_allreduce_per_step": grad_calls_per_step,
          "seq_sec_per_chip": result["seq_sec_per_chip"],
          "mfu": result["mfu"], "final_loss": result["final_loss"],
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "wall_s": wall, "card": card})
    return flash, adam


def _profile_steps(step, state, args, steps: int = 3):
    """``steps`` calls of ``step(state, *args)`` under torch.profiler after
    2 warm-up calls: wall ms per step and the device kernels' spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        state, loss = step(state, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step(state, *args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        fail("profile: the profiler recorded no device kernels")
    return wall_ms / steps, spans, loss.item()


def phase_gpt_profile(htt):
    """3 GPT main-path steps (GPT-2 small, batch 4, seq 1024, bf16, flash
    attention, fused Adam) under torch.profiler: device time per step by
    kind, and the device's idle share."""
    from horovod_tpu_torch.models import gpt2_small, next_token_loss

    model = gpt2_small(generator=torch.Generator().manual_seed(0))
    opt = htt.fused_adam(1e-4)
    step = htt.make_train_step(apply_fn=model, loss_fn=next_token_loss,
                               optimizer=opt, loss_fetch_steps=0)
    state = htt.init_train_state(model, opt)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1000, size=(4, 1024))).to(htt.device())
    steps = 3
    wall_ms, spans, loss = _profile_steps(step, state, (ids, ids), steps)
    flash = {}
    for start, end, name in spans:
        if _kernel_kind(name) == "flash":
            n, ms = flash.get(name, (0, 0.0))
            flash[name] = (n + 1, ms + (end - start) / 1e3)
    emit({"phase": "gpt_profile", "model": "gpt2_small", "steps": steps,
          "wall_ms_per_step": wall_ms, **device_breakdown(spans, steps),
          "flash_ms_per_launch": {n[:60]: ms / k
                                  for n, (k, ms) in flash.items()},
          "final_loss": loss})


def phase_profile(htt):
    """3 main-path steps (ResNet-50, 224x224, batch 128, bf16, fused
    momentum) under torch.profiler: device time per step by kind of
    kernel, and the device's idle share between the first kernel's start
    and the last one's end."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50

    device = htt.device()
    gen = torch.Generator(device=device).manual_seed(42)
    x = torch.rand((128, 224, 224, 3), generator=gen, device=device)
    y = torch.randint(0, 1000, (128,), generator=gen, device=device)
    model = ResNet50(generator=torch.Generator().manual_seed(0)).to(
        device, memory_format=torch.channels_last)
    opt = htt.fused_sgd(0.01, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, has_batch_stats=True,
                               loss_fetch_steps=0)
    state = htt.init_train_state(model, opt, has_batch_stats=True)
    steps = 3
    wall_ms, spans, loss = _profile_steps(step, state, (x, y), steps)
    emit({"phase": "profile", "model": "ResNet50", "steps": steps,
          "wall_ms_per_step": wall_ms, **device_breakdown(spans, steps),
          "final_loss": loss})
    del model, state, step


def phase_rules(htt, kernels):
    """Fused SGD and fused Adam, 3 trainer steps each at the main path's
    shapes; returns each rule's K1 launches by parameter-group type."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50

    device = htt.device()
    gen = torch.Generator(device=device).manual_seed(42)
    x = torch.rand((128, 224, 224, 3), generator=gen, device=device)
    y = torch.randint(0, 1000, (128,), generator=gen, device=device)
    launches = {}
    for rule, opt in (("sgd", htt.fused_sgd(0.01)),
                      ("adam", htt.fused_adam(1e-3))):
        model = ResNet50(generator=torch.Generator().manual_seed(0)).to(
            device, memory_format=torch.channels_last)
        step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                   optimizer=opt, has_batch_stats=True,
                                   loss_fetch_steps=0)
        state = htt.init_train_state(model, opt, has_batch_stats=True)
        reset_counts(kernels)
        for _ in range(3):
            state, loss = step(state, x, y)
        final = loss.item()
        launches[rule] = _k1(kernels, rule)
        if not math.isfinite(final) or sum(launches[rule].values()) != 3 or \
                sum(kernels.fused_update_launches.values()) != 3:
            fail(f"rules: {rule} loss {final}, launches "
                 f"{kernels.fused_update_launches}")
        emit({"phase": "rules", "rule": rule, "steps": 3,
              "k1_launches": launches[rule], "final_loss": final})
        del model, state, step
    return launches


#: the counters of K8-K10
CONV_COUNTERS = ("bn_relu", "stats", "plain")
#: the kernels line's entries of K6-K10, in order
VARIANT_KEYS = ("K6", "K6'", "K7", "K8", "K9", "K10")
#: the counter of each of them
VARIANT_COUNTERS = {"K6": "scale_bias_relu", "K6'": "relu_grad",
                    "K7": "residual_relu", "K8": "bn_relu", "K9": "stats",
                    "K10": "plain"}


def run_variant_phases(htt, kernels, ew, cb, flops_mod, card,
                       default_img_sec) -> dict:
    """The phases of K6-K10: each kernel against its plain version, the
    card-vs-CPU parity of the variant models, their main path and
    profile.  Returns the kernels' entries, launches from the main
    path."""
    results = phase_elementwise_kernels(kernels, ew, flops_mod)
    results.update(phase_conv_kernels(kernels, cb, flops_mod))
    phase_variants_parity(htt, kernels)
    launches, by_loop = phase_variants_main_path(kernels, flops_mod, card,
                                                 default_img_sec)
    for key, counter in VARIANT_COUNTERS.items():
        results[key]["launches"] = launches[counter]
        if counter in CONV_COUNTERS:
            results[key]["launches_by_mainloop"] = {
                k.split(".")[1]: v for k, v in by_loop.items()
                if k.startswith(counter + ".")}
    phase_variants_profile(htt)
    return results


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flash-only", action="store_true",
                    help="run the device, build and flash_kernels phases")
    ap.add_argument("--variants-only", action="store_true",
                    help="run the device and build phases and those of "
                         "K6-K10 (elementwise_kernels to variants_profile)")
    cli = ap.parse_args()
    flash_only, variants_only = cli.flash_only, cli.variants_only
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA card")
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import kernels
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.ops import elementwise as ew
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim import fused_update as fu
    from horovod_tpu_torch.utils import flops as flops_mod

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = kernels.build(force=True, verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(kernels.LIB_PATH.relative_to(
              kernels.BUILD_DIR.parents[1]))})
    print(log, file=sys.stderr, flush=True)

    # CPU tensors (the parity phase's reference run) reduce over gloo,
    # CUDA tensors over NCCL, on one world-size-1 group
    htt.init(backend="cpu:gloo,cuda:nccl")
    if flash_only:
        phase_flash_kernels(kernels, fa, flops_mod)
        htt.shutdown()
        return
    if variants_only:
        results = run_variant_phases(htt, kernels, ew, cb, flops_mod, card,
                                     None)
        emit({"kernels": [results[k] for k in VARIANT_KEYS]})
        htt.shutdown()
        return
    results = phase_kernels(fu, flops_mod)
    results.update(phase_flash_kernels(kernels, fa, flops_mod))
    phase_parity(htt)
    phase_gpt_parity(htt, kernels)
    phase_gpt_bf16(kernels, fa)
    k1_launches = {}
    k1_launches["momentum"], default_img_sec = phase_main_path(
        kernels, flops_mod, card)
    phase_profile(htt)
    results.update(run_variant_phases(htt, kernels, ew, cb, flops_mod, card,
                                      default_img_sec))
    k1_launches.update(phase_rules(htt, kernels))
    flash, k1_launches["adam"] = phase_gpt_main_path(htt, kernels, card)
    for rule, by_dtype in k1_launches.items():
        results[rule]["launches"] = by_dtype["float32"]
        results[rule]["bf16"]["launches"] = by_dtype["bfloat16"]
    for key, counter in (("K2", "fwd"), ("K3", "bwd_dq"),
                         ("K4", "bwd_dkv")):
        results[key]["launches"] = flash[counter]
    phase_gpt_profile(htt)
    htt.shutdown()

    emit({"kernels": [results[r] for r in ("momentum", "sgd", "adam", "K2",
                                           "K3", "K4", *VARIANT_KEYS)],
          "card": card, "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
