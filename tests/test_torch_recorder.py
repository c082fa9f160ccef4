"""horovod_tpu_torch.timeline.recorder against
horovod_tpu.timeline.recorder.

* The DAG comes from make_fx of the step (the reference's make_jaxpr):
  input, op and output nodes, every edge between two of them, networkx
  reads the GML; the port's kernels are ops of their own, one node per
  launch with edges from their inputs (K1 on the MLP's step, K2-K4 on a
  1-layer GPT's, through their plain versions on the CPU); the state is
  left as it was.
* For the MLP with the reference's weights (converted),
  ``gradient_name_list.json`` and the gradients' shapes and dtypes in
  ``tensor_shapes.json`` / ``tensor_dtypes.json`` equal the reference's;
  ``metadata.json`` has its keys.
* ``TimelineHook`` records the STEP spans of its window only; the
  frontend's optimizer writes the gradient manifest.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu as hvd
from horovod_tpu.models.mlp import MLP as RefMLP
from horovod_tpu.timeline.recorder import Recorder as RefRecorder
from horovod_tpu_torch import core, training
from horovod_tpu_torch.convert import canonical_layouts, load_flax_variables
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.models.gpt import GPT, next_token_loss
from horovod_tpu_torch.optim.fused_update import fused_adam, fused_sgd
from horovod_tpu_torch.timeline.recorder import (
    Recorder, TimelineHook, fx_dag,
)


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE", "HVD_TIMELINE", "HVD_TRACE_DIR",
              "HVD_PROFILE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def _step(w, x):
    return torch.tanh(x @ w).sum()


def _valid(nodes, edges):
    ids = {n["id"] for n in nodes}
    assert {"input", "op", "output"} <= {n["kind"] for n in nodes}
    assert edges and all(s in ids and t in ids for s, t in edges)
    into = {t for _, t in edges}
    assert all(n["id"] in into for n in nodes if n["kind"] == "output")


def test_fx_dag_structure():
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(_step)(torch.ones(3, 4), torch.ones(2, 3))
    nodes, edges = fx_dag(gm.graph)
    _valid(nodes, edges)
    labels = {n["label"] for n in nodes}
    assert "aten.mm" in labels and "aten.tanh" in labels
    inputs = [n for n in nodes if n["kind"] == "input"]
    assert [n["shape"] for n in inputs] == [[3, 4], [2, 3]]
    assert inputs[0]["dtype"] == "float32"


def _mlp(seed=3):
    rng = np.random.default_rng(21)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    y = rng.integers(0, 6, size=(8,)).astype(np.int32)
    ref = RefMLP(features=(16, 6))
    variables = jax.tree_util.tree_map(
        np.asarray, ref.init(jax.random.PRNGKey(seed), x))
    model = MLP(12, (16, 6))
    load_flax_variables(model, variables["params"])
    return variables, model, torch.from_numpy(x), torch.from_numpy(y).long()


def _in_degree(edges):
    deg = {}
    for _, t in edges:
        deg[t] = deg.get(t, 0) + 1
    return deg


def test_recorder_dumps_the_mlp_step_and_leaves_its_state(port_cpu_world,
                                                          tmp_path):
    _, model, x, y = _mlp()
    opt = fused_sgd(0.1, momentum=0.9)
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt, loss_fetch_steps=0)
    state = training.init_train_state(model, opt)
    before = [t.clone() for t in training._state_tensors(state)]
    rec = Recorder(str(tmp_path))
    graph = rec.record_step_function(step.eager, state, x, y)
    assert graph is not None
    assert all(torch.equal(a, b) for a, b in
               zip(before, training._state_tensors(state)))
    gml = (tmp_path / "0" / "dag.gml").read_text()
    assert gml.startswith("graph [")
    nodes, edges = fx_dag(graph)
    _valid(nodes, edges)
    k1 = [n["id"] for n in nodes if n["label"] == "hvd.fused_update"]
    assert len(k1) == 1 and _in_degree(edges)[k1[0]] >= 2
    assert any(n["label"] == "c10d.allreduce_" for n in nodes)
    shapes = json.loads((tmp_path / "0" / "tensor_shapes.json").read_text())
    assert [8, 12] in shapes.values()
    # a step taken after it is the step the state would have taken
    state, loss = step(state, x, y)
    assert np.isfinite(loss.item())


def test_gml_readable_by_networkx(port_cpu_world, tmp_path):
    nx = pytest.importorskip("networkx")
    rec = Recorder(str(tmp_path))
    rec.record_step_function(_step, torch.ones(3, 4), torch.ones(2, 3))
    g = nx.read_gml(str(tmp_path / "0" / "dag.gml"), label="id")
    nodes, edges = fx_dag(__import__(
        "torch.fx.experimental.proxy_tensor", fromlist=["make_fx"]).make_fx(
            _step)(torch.ones(3, 4), torch.ones(2, 3)).graph)
    assert g.number_of_nodes() == len(nodes)
    assert g.number_of_edges() == len(edges)


def test_the_flash_kernels_are_nodes_of_the_gpt_step(port_cpu_world,
                                                     tmp_path):
    gen = torch.Generator().manual_seed(0)
    model = GPT(vocab_size=64, num_layers=1, num_heads=2, hidden_dim=32,
                mlp_dim=64, max_len=16, dtype=torch.float32, generator=gen)
    opt = fused_adam(1e-3)
    step = training.make_train_step(apply_fn=model, loss_fn=next_token_loss,
                                    optimizer=opt, loss_fetch_steps=0)
    state = training.init_train_state(model, opt)
    ids = torch.randint(0, 64, (2, 16), generator=gen)
    graph = Recorder(str(tmp_path)).record_step_function(step.eager, state,
                                                         ids, ids)
    nodes, edges = fx_dag(graph)
    _valid(nodes, edges)
    deg = _in_degree(edges)
    for label, n, ins in (("hvd.flash_fwd", 1, 3), ("hvd.flash_bwd_dq", 1, 6),
                          ("hvd.flash_bwd_dkv", 1, 6),
                          ("hvd.fused_update", 1, 2)):
        found = [m["id"] for m in nodes if m["label"] == label]
        assert len(found) == n, label
        assert all(deg.get(i, 0) >= ins for i in found), label


def test_gradient_manifest_equals_the_references(port_cpu_world, tmp_path,
                                                 cpu_devices):
    variables, model, _, _ = _mlp()
    hvd.shutdown()
    hvd.init(devices=cpu_devices[:1])
    try:
        ref = RefRecorder(str(tmp_path / "ref"))
        ref.register_gradients(jax.tree_util.tree_map(
            jnp.asarray, variables["params"]))
        ref.dump_metadata(model="MLP")
    finally:
        hvd.shutdown()
    opt = fused_sgd(0.1)
    state = training.init_train_state(model, opt)
    rec = Recorder(str(tmp_path / "port"))
    rec.register_gradients(state.params, canonical_layouts(model))
    rec.dump_metadata(model="MLP")
    for name in ("gradient_name_list.json", "tensor_shapes.json",
                 "tensor_dtypes.json"):
        got = json.loads((tmp_path / "port" / "0" / name).read_text())
        want = json.loads((tmp_path / "ref" / "0" / name).read_text())
        assert got == want, name
    got = json.loads((tmp_path / "port" / "0" / "metadata.json").read_text())
    want = json.loads((tmp_path / "ref" / "0" / "metadata.json").read_text())
    assert sorted(got) == sorted(want)
    assert got["platform"] == want["platform"] == "cpu"
    assert got["model"] == "MLP" and got["size"] == 1


def test_timeline_hook_records_its_window(port_cpu_world, tmp_path,
                                          monkeypatch):
    from horovod_tpu_torch.timeline.timeline import timeline

    monkeypatch.setenv("HVD_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("HVD_TRACE_START_STEP", "2")
    monkeypatch.setenv("HVD_TRACE_END_STEP", "3")
    hook = TimelineHook(Recorder())
    assert (hook.start_step, hook.end_step) == (2, 3)
    for _ in range(5):
        with hook.step():
            pass
    assert not timeline.active     # closed past the end step
    timeline.shutdown()
    events = json.loads((tmp_path / "0" / "comm.json").read_text())
    assert [e["cat"] for e in events] == ["step_2", "step_3"]


def test_the_frontend_writes_the_gradient_manifest(port_cpu_world, tmp_path,
                                                   monkeypatch):
    import horovod_tpu_torch.torch as hvd_torch

    monkeypatch.setenv("HVD_TRACE_DIR", str(tmp_path))
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.ReLU(),
                                torch.nn.Linear(4, 3))
    opt = hvd_torch.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    for _ in range(2):
        opt.zero_grad()
        model(torch.ones(2, 5)).sum().backward()
        opt.step()
    d = tmp_path / "0"
    names = json.loads((d / "gradient_name_list.json").read_text())
    assert names == [f"gradients/{n}" for n, _ in model.named_parameters()]
    shapes = json.loads((d / "tensor_shapes.json").read_text())
    assert shapes["gradients/0.weight"] == [4, 5]
    meta = json.loads((d / "metadata.json").read_text())
    assert meta["framework"] == "torch" and meta["num_gradients"] == 4
    assert "allreduce/0.weight" in (d / "dag.gml").read_text()


def test_recorder_disabled(monkeypatch):
    monkeypatch.delenv("HVD_TRACE_DIR", raising=False)
    monkeypatch.delenv("HVD_TIMELINE", raising=False)
    rec = Recorder(None)
    assert not rec.enabled
    assert rec.record_step_function(_step, torch.ones(3, 4),
                                    torch.ones(2, 3)) is None
    rec.register_gradients({"w": torch.ones(2)})
    rec.dump_metadata()
