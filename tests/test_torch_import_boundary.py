"""horovod_tpu_torch's import boundary: the port imports torch and numpy,
never JAX (nor flax / optax) and nothing of the JAX package — checked on
a fresh interpreter and by an AST scan of the package and
chip_smoke.py — and its entry points refuse to fall back to the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "horovod_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax"}


def _forbidden(module: str) -> bool:
    """The module ``horovod_tpu`` or the prefix ``horovod_tpu.`` — not the
    bare string, which ``horovod_tpu_torch`` also starts with."""
    return (module.split(".")[0] in FORBIDDEN_ROOTS
            or module == "horovod_tpu" or module.startswith("horovod_tpu."))


def _absolute_imports(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_fresh_import_leaves_jax_and_reference_out():
    code = """
import importlib, json, pkgutil, sys
import horovod_tpu_torch
for m in pkgutil.walk_packages(horovod_tpu_torch.__path__, "horovod_tpu_torch."):
    importlib.import_module(m.name)
import horovod_tpu_torch.examples.synthetic_benchmark
import horovod_tpu_torch.examples.gpt_synthetic_benchmark
import horovod_tpu_torch.examples.bert_synthetic_benchmark
import horovod_tpu_torch.examples.pytorch_synthetic_benchmark
import horovod_tpu_torch.examples.multichip_drives
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("horovod_tpu_torch.training", "horovod_tpu_torch.models.gpt",
              "horovod_tpu_torch.models.bert",
              "horovod_tpu_torch.ops.flash_attention",
              "horovod_tpu_torch.ops.elementwise",
              "horovod_tpu_torch.ops.conv_bn",
              "horovod_tpu_torch.examples.gpt_synthetic_benchmark",
              "horovod_tpu_torch.examples.bert_synthetic_benchmark",
              "horovod_tpu_torch.examples.synthetic_benchmark",
              "horovod_tpu_torch.models.vgg",
              "horovod_tpu_torch.models.inception",
              "horovod_tpu_torch.models.vit",
              "horovod_tpu_torch.optim.transforms",
              "horovod_tpu_torch.ops.adasum",
              "horovod_tpu_torch.ops.sparse",
              "horovod_tpu_torch.parallel.hierarchical",
              "horovod_tpu_torch.optim.distributed",
              "horovod_tpu_torch.eager",
              "horovod_tpu_torch.elastic.join",
              "horovod_tpu_torch.callbacks",
              "horovod_tpu_torch.torch",
              "horovod_tpu_torch.examples.pytorch_synthetic_benchmark",
              "horovod_tpu_torch.parallel.mesh",
              "horovod_tpu_torch.parallel.ring_attention",
              "horovod_tpu_torch.parallel.tensor_parallel",
              "horovod_tpu_torch.parallel.pipeline",
              "horovod_tpu_torch.parallel.moe",
              "horovod_tpu_torch.examples.multichip_drives",
              "horovod_tpu_torch.metrics",
              "horovod_tpu_torch.metrics.registry",
              "horovod_tpu_torch.metrics.timeseries",
              "horovod_tpu_torch.observe.events",
              "horovod_tpu_torch.runtime.native",
              "horovod_tpu_torch.timeline.timeline",
              "horovod_tpu_torch.timeline.recorder",
              "horovod_tpu_torch.timeline.profiler",
              "horovod_tpu_torch.utils.slo",
              "horovod_tpu_torch.timeline.comm_report",
              "horovod_tpu_torch.timeline.merge",
              "horovod_tpu_torch.timeline.replay",
              "horovod_tpu_torch.timeline.replay.clock",
              "horovod_tpu_torch.timeline.replay.stitcher",
              "horovod_tpu_torch.timeline.replay.critical_path",
              "horovod_tpu_torch.timeline.replay.simulator",
              "horovod_tpu_torch.timeline.replay.fixture",
              "horovod_tpu_torch.timeline.replay.projection",
              "horovod_tpu_torch.optim.autotune",
              "horovod_tpu_torch.optim.profile_guided",
              "horovod_tpu_torch.optim.compute_knobs",
              "horovod_tpu_torch.data",
              "horovod_tpu_torch.data.loader",
              "horovod_tpu_torch.run",
              "horovod_tpu_torch.run.__main__",
              "horovod_tpu_torch.run.store",
              "horovod_tpu_torch.run.http_server",
              "horovod_tpu_torch.run.http_client",
              "horovod_tpu_torch.run.journal",
              "horovod_tpu_torch.run.relay",
              "horovod_tpu_torch.run.hosts",
              "horovod_tpu_torch.run.discovery",
              "horovod_tpu_torch.run.config_parser",
              "horovod_tpu_torch.run.run",
              "horovod_tpu_torch.run.task_fn",
              "horovod_tpu_torch.runtime.stall_inspector",
              "horovod_tpu_torch.metrics.push",
              "horovod_tpu_torch.elastic.abort",
              "horovod_tpu_torch.elastic.heartbeat",
              "horovod_tpu_torch.observe.autoarm"):
        assert m in mods
    assert [m for m in mods if _forbidden(m)] == []


def _lazy_imports(path: Path):
    """The modules a file imports inside its functions, resolved to
    absolute names (relative ones against the file's package)."""
    pkg = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    out = set()
    for fn in ast.walk(ast.parse(path.read_text())):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Import):
                out |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                base = pkg.split(".")
                if node.level:
                    base = base[:len(base) - node.level + 1]
                    name = ".".join(base + ([node.module]
                                            if node.module else []))
                else:
                    name = node.module
                out.add(name)
    return out


@pytest.mark.parametrize("module,reaches", [
    ("optim/profile_guided.py", {"horovod_tpu_torch.timeline.replay",
                                 "horovod_tpu_torch.timeline.comm_report"}),
    ("optim/compute_knobs.py", {"horovod_tpu_torch.data.loader"}),
])
def test_lazy_imports_stay_within_the_port(module, reaches):
    """The tuners import the replay engine, the comm model and the
    loader inside their functions: those imports resolve into the port
    (statically), and running them in a fresh interpreter brings in no
    JAX and nothing of the JAX package."""
    lazy = _lazy_imports(PKG / module)
    assert reaches <= lazy
    assert [m for m in lazy if _forbidden(m)] == []
    code = f"""
import json, sys, tempfile
import horovod_tpu_torch as htt
from horovod_tpu_torch.optim import compute_knobs, profile_guided
from horovod_tpu_torch.optim.autotune import TunableParams
from horovod_tpu_torch.timeline.replay.fixture import (
    write_autotune_fixture_trace)
if {module!r} == "optim/profile_guided.py":
    d = tempfile.mkdtemp()
    write_autotune_fixture_trace(d)
    assert profile_guided.plan_from_trace(d) is not None
    profile_guided.predicted_score_fn(1e8, 8)(TunableParams())
else:
    htt.init(device="cpu")
    compute_knobs.run_bench_fixture(steps=1, host_delay_s=0.0,
                                    profile_steps=1)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert reaches <= set(mods)
    assert [m for m in mods if _forbidden(m)] == []


def test_ast_scan_finds_no_forbidden_import():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _absolute_imports(f.read_text()) if _forbidden(m)]
    assert bad == []


@pytest.mark.parametrize("source,flagged", [
    ("import jax.numpy as jnp", True),
    ("from flax import linen", True),
    ("import optax", True),
    ("from horovod_tpu.optim import fused_update", True),
    ("import horovod_tpu", True),
    ("import horovod_tpu_torch.core", False),
    ("from horovod_tpu_torch import kernels", False),
    ("from .core import init", False),
])
def test_scan_rule_matches_module_not_string_prefix(source, flagged):
    assert any(_forbidden(m) for m in _absolute_imports(source)) == flagged


def test_init_without_cuda_and_without_cpu_request_raises(monkeypatch):
    from horovod_tpu_torch import core

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    core.shutdown()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.init()
    assert not core.is_initialized()


def test_benchmark_without_cuda_raises(monkeypatch):
    from horovod_tpu_torch import core
    from horovod_tpu_torch.examples import synthetic_benchmark as sb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    core.shutdown()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sb.run(sb.parse_args(["--model", "ResNet18"]))
    assert not core.is_initialized()


def test_gpt_benchmark_without_cuda_raises(monkeypatch):
    from horovod_tpu_torch import core
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    core.shutdown()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gb.run(gb.parse_args(["--model", "tiny"]))
    assert not core.is_initialized()


def test_library_attention_is_never_called_by_the_port():
    """scaled_dot_product_attention (and cuDNN's or any fused attention)
    is only timed beside K2 in chip_smoke.py; the package never calls
    it."""
    hits = [str(f.relative_to(REPO)) for f in sorted(PKG.rglob("*.py"))
            if "scaled_dot_product_attention" in f.read_text()]
    assert hits == []
    assert "scaled_dot_product_attention" in (REPO / "chip_smoke.py"
                                              ).read_text()


def test_flash_wrapper_binds_every_kernel_entry_point():
    """csrc/flash_attention.cu's C entry points and the argument block
    kernels.py hands them: one name for one name, field for field."""
    from horovod_tpu_torch import kernels

    src = (PKG / "csrc" / "flash_attention.cu").read_text()
    for fn in ("hvd_flash_fwd", "hvd_flash_bwd_dq", "hvd_flash_bwd_dkv"):
        assert f"int {fn}(const HvdFlashArgs* a, void* stream)" in src
        assert f"lib.{fn}" in (PKG / "kernels.py").read_text()
    body = src[src.index("struct HvdFlashArgs {"):]
    body = body[:body.index("};")]
    declared = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            first, *rest = decl.split(",")
            declared += [n.strip(" *") for n in [first.split()[-1], *rest]]
    assert declared == [n for n, _ in kernels._FlashArgs._fields_]


def _struct_fields(src: str, name: str):
    """The member names of ``struct <name> { ... };`` in a C source."""
    body = src[src.index(f"struct {name} {{"):]
    body = body[:body.index("};")]
    declared = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            first, *rest = decl.split(",")
            declared += [n.strip(" *") for n in [first.split()[-1], *rest]]
    return declared


def test_resnet_variant_wrappers_bind_every_kernel_entry_point():
    """csrc/elementwise.cu's and csrc/conv_bn.cu's C entry points are the
    ones kernels.py binds, and HvdConvArgs is mirrored field for field by
    kernels._ConvArgs."""
    from horovod_tpu_torch import kernels

    binding = (PKG / "kernels.py").read_text()
    for src, fns in (("elementwise.cu", ("hvd_residual_relu",
                                         "hvd_relu_grad",
                                         "hvd_scale_bias_relu")),
                     ("conv_bn.cu", ("hvd_conv3x3",
                                     "hvd_conv3x3_wgmma_occupancy"))):
        text = (PKG / "csrc" / src).read_text()
        for fn in fns:
            assert f" {fn}(" in text and f"lib.{fn}" in binding
    conv = (PKG / "csrc" / "conv_bn.cu").read_text()
    assert "int hvd_conv3x3(const HvdConvArgs* args, void* stream)" in conv
    assert _struct_fields(conv, "HvdConvArgs") == \
        [n for n, _ in kernels._ConvArgs._fields_]


def test_library_conv_twins_are_never_called_by_the_port():
    """The cuDNN twins of K8 and K9 (ops/conv_bn.py torch_conv3x3_*) are
    the tests' and chip_smoke.py's yardstick; no other module of the
    package calls them."""
    hits = [str(f.relative_to(REPO)) for f in sorted(PKG.rglob("*.py"))
            if "torch_conv3x3_" in f.read_text()]
    assert hits == ["horovod_tpu_torch/ops/conv_bn.py"]


def test_kernel_wrapper_never_falls_back_for_cuda_tensors():
    """A CUDA tensor goes to the kernel or raises; here (meta tensors
    standing in for card tensors) the wrapper's checks raise before any
    build, rather than quietly running the plain version."""
    from horovod_tpu_torch import kernels
    from horovod_tpu_torch.optim.fused_update import flat_update_

    p = torch.empty(8, device="meta")
    before = dict(kernels.fused_update_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.launch_fused_update("sgd", p, p, lr=0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flat_update_("momentum", p, p, torch.empty_like(p), lr=0.1,
                     momentum=0.9)
    assert kernels.fused_update_launches == before


#: definitions that live in csrc/hopper.cuh alone
HOPPER_HELPERS = ("void mbar_wait(", "void mbar_arrive_expect_tx(",
                  "void tma_load_4d(", "void tma_load_im2col(",
                  "uint64_t gmma_desc(", "void wgmma_fence(",
                  "void wgmma_ss_m64n64k16(", "void wgmma_rs_m64n64k16(",
                  "void* driver_entry(", "cudaError_t allow_smem_once(")


def test_hopper_helpers_live_in_one_header():
    """The mbarrier, TMA and wgmma wrappers, the tensor-map encoders and
    the shared-memory limit are defined once, in csrc/hopper.cuh, which
    both TMA + wgmma mainloops (K8-K10 in conv_bn.cu, K2 and K4 in
    flash_attention.cu) include."""
    csrc = PKG / "csrc"
    header = (csrc / "hopper.cuh").read_text()
    assert [d for d in HOPPER_HELPERS if d not in header] == []
    for src in sorted(csrc.glob("*.cu")):
        text = src.read_text()
        assert [d for d in HOPPER_HELPERS if d in text] == [], src.name
    for name in ("conv_bn.cu", "flash_attention.cu"):
        assert '#include "hopper.cuh"' in (csrc / name).read_text()


def test_library_is_rebuilt_when_a_header_changes(tmp_path, monkeypatch):
    """kernels._stale watches the headers beside the sources: a newer
    hopper.cuh makes the built library stale."""
    from horovod_tpu_torch import kernels

    src = tmp_path / "csrc"
    src.mkdir()
    lib = tmp_path / "libhvd_torch_kernels.so"
    for path in (src / "flash_attention.cu", src / "hopper.cuh", lib):
        path.write_text("")
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "LIB_PATH", lib)
    os.utime(src / "flash_attention.cu", (1000, 1000))
    os.utime(src / "hopper.cuh", (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not kernels._stale()
    os.utime(src / "hopper.cuh", (3000, 3000))
    assert kernels._stale()


def test_frontend_benchmark_without_cuda_raises(monkeypatch):
    from horovod_tpu_torch import core
    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as pb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    core.shutdown()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pb.run(pb.parse_args(["--model", "smallconv"]))
    assert not core.is_initialized()


def test_frontend_subpackage_imports_the_top_level_torch():
    """Inside ``horovod_tpu_torch/torch/`` ``import torch`` is PyTorch
    (absolute imports), and nothing imports the subpackage relatively
    as ``torch``."""
    import horovod_tpu_torch.torch as frontend

    assert frontend.torch is torch
    for f in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert not any(a.name == "torch" for a in node.names), f


def test_the_kernels_are_library_ops_with_flop_formulas():
    """K1-K4 and K6-K10 are ``torch.library`` ops of the ``hvd``
    namespace, with CPU (plain version) and CUDA (kernel)
    implementations, a fake and a FLOP formula each — what make_fx and
    FlopCounterMode see of them."""
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    import horovod_tpu_torch.ops.conv_bn  # noqa: F401
    import horovod_tpu_torch.ops.flash_attention  # noqa: F401
    import horovod_tpu_torch.optim.fused_update  # noqa: F401

    q = torch.randn(1, 2, 8, 16)
    with FlopCounterMode(display=False) as counter:
        torch.ops.hvd.flash_fwd(q, q, q, True, 0.25, 0, 0, True)
        torch.ops.hvd.fused_update("sgd", torch.zeros(5), torch.ones(5),
                                   None, None, None, 0.1, 0, 0, 0, 0, 0, 0)
    pairs = 8 * 9 // 2
    assert counter.get_total_flops() == 2 * 16 * 2 * 2 * pairs + 2 * 5
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "fused_update", "residual_relu", "relu_grad",
                 "scale_bias_relu", "conv3x3_bn_relu", "conv3x3_stats",
                 "conv3x3_plain"):
        packet = getattr(torch.ops.hvd, name)
        assert packet in flop_registry, name
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                packet.default.name(), key), (name, key)
