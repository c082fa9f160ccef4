"""horovod_tpu_torch's import boundary: the port imports torch and numpy,
never JAX (nor flax / optax) and nothing of the JAX package — checked on
a fresh interpreter and by an AST scan of the package and
chip_smoke.py — and its entry points refuse to fall back to the CPU."""

import ast
import json
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
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "horovod_tpu_torch.training" in mods
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
