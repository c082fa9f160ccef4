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
   ResNet-50's 25,557,032 parameters and at a ragged 1,000,003; then each
   rule's time (CUDA events, median of 25) beside the plain version's,
   ``torch.optim``'s fused step on the same buffers (timed only, the port
   never calls it) and the bound from the bytes it must move.
4. parity  — a narrow ResNet-18 at 64×64 trained 2 steps in float32 from
   the same seeded weights on the card (K1) and on the CPU (plain), with
   TF32 off for convolutions and matmuls; losses, parameters and
   BatchNorm statistics compared.
5. main path — ``examples.synthetic_benchmark.run``: ResNet-50, 224×224,
   batch 128, bf16, ``--fused-optimizer``, world size 1 over NCCL.  Checks
   a finite loss, one K1 launch per step and one gradient ``all_reduce``
   per fusion bucket per step; reports img/s and MFU.
6. profile — 3 more main-path steps under torch.profiler: device time
   per step by kind of kernel and the device's idle share.
7. rules   — the same trainer 3 steps each with fused SGD and fused Adam,
   so every K1 rule runs on a training path.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line.
"""

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import torch

PARAMS_RESNET50 = 25_557_032
RAGGED = 1_000_003
TIMED_RUNS = 25

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
    CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
        max_abs = max_rel = 0.0
        for n in (PARAMS_RESNET50, RAGGED):
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

        # timing at ResNet-50's size
        n = PARAMS_RESNET50
        gen = torch.Generator(device="cuda").manual_seed(7)
        p = torch.randn(n, device="cuda", generator=gen)
        g = torch.randn(n, device="cuda", generator=gen)
        mu, nu = torch.zeros_like(p), torch.zeros_like(p)
        s = opt._scalars(1)
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
        library_ms = cuda_ms(lib.step)
        replaces, bytes_per, flops_per = RULES[rule]
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
        }
    emit({"phase": "kernels", "rules": {
        r: {k: v[k] for k in ("max_abs_err", "max_rel_err", "ms",
                              "plain_ms", "library_ms", "bound_ms")}
        for r, v in results.items()}})
    return results


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

    for k in kernels.fused_update_launches:
        kernels.fused_update_launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    dist.all_reduce = counting_all_reduce
    try:
        t0 = time.perf_counter()
        result = sb.run(sb.parse_args(argv))
        wall = time.perf_counter() - t0
    finally:
        dist.all_reduce = all_reduce
    launches = dict(kernels.fused_update_launches)

    if not math.isfinite(result["final_loss"]):
        fail(f"main path: final loss {result['final_loss']}")
    if launches["momentum"] != steps or launches["sgd"] or launches["adam"]:
        fail(f"main path: K1 launches {launches}, want {steps} momentum")
    # one all_reduce per gradient bucket, plus one for the reported loss
    grad_calls_per_step = calls[0] / steps - 1
    if grad_calls_per_step != buckets:
        fail(f"main path: {calls[0]} all_reduce calls over {steps} steps, "
             f"want {buckets} buckets + 1 loss per step")
    emit({"phase": "main_path", "model": "ResNet50", "image_size": 224,
          "batch_per_chip": 128, "dtype": "bfloat16", "optimizer":
          "fused momentum (K1)", "world_size": result["size"],
          "steps": steps, "k1_launches": launches["momentum"],
          "fusion_buckets": buckets,
          "grad_allreduce_per_step": grad_calls_per_step,
          "img_sec_per_chip": result["img_sec_per_chip"],
          "img_sec_conf": result["conf"],
          "mfu": flops_mod.image_model_mfu(result["img_sec_per_chip"]),
          "peak_flops": flops_mod.peak_flops(),
          "final_loss": result["final_loss"],
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "wall_s": wall, "card": card})
    return launches["momentum"]


def _kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name, for the step breakdown."""
    low = name.lower()
    if any(k in low for k in ("momentum_kernel", "sgd_kernel",
                              "adam_kernel")):
        return "K1"
    if "nccl" in low:
        return "nccl"
    if "bn_" in low or "batch_norm" in low or "batchnorm" in low:
        return "batchnorm"
    if any(k in low for k in ("xmma", "gemm", "conv", "cutlass", "wgrad",
                              "dgrad", "fprop", "nchwtonhwc",
                              "nhwctonchw")):
        return "conv_matmul"
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


def phase_profile(htt):
    """3 main-path steps (ResNet-50, 224x224, batch 128, bf16, fused
    momentum) under torch.profiler: device time per step by kind of
    kernel, and the device's idle share between the first kernel's start
    and the last one's end."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    for _ in range(2):
        state, loss = step(state, x, y)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step(state, x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        fail("profile: the profiler recorded no device kernels")
    emit({"phase": "profile", "model": "ResNet50", "steps": steps,
          "wall_ms_per_step": wall_ms / steps,
          **device_breakdown(spans, steps), "final_loss": loss.item()})
    del model, state, step


def phase_rules(htt, kernels):
    """Fused SGD and fused Adam, 3 trainer steps each at the main path's
    shapes; returns each rule's K1 launches."""
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
        for k in kernels.fused_update_launches:
            kernels.fused_update_launches[k] = 0
        for _ in range(3):
            state, loss = step(state, x, y)
        final = loss.item()
        launches[rule] = kernels.fused_update_launches[rule]
        if not math.isfinite(final) or launches[rule] != 3 or \
                sum(kernels.fused_update_launches.values()) != 3:
            fail(f"rules: {rule} loss {final}, launches "
                 f"{kernels.fused_update_launches}")
        emit({"phase": "rules", "rule": rule, "steps": 3,
              "k1_launches": launches[rule], "final_loss": final})
        del model, state, step
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA card")
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import kernels
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
    results = phase_kernels(fu, flops_mod)
    phase_parity(htt)
    results["momentum"]["launches"] = phase_main_path(kernels, flops_mod,
                                                      card)
    phase_profile(htt)
    for rule, n in phase_rules(htt, kernels).items():
        results[rule]["launches"] = n
    htt.shutdown()

    emit({"kernels": [results[r] for r in ("momentum", "sgd", "adam")],
          "card": card, "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
