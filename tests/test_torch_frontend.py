"""horovod_tpu_torch.torch (the Horovod torch frontend) against
horovod_tpu.torch, the JAX package's torch frontend, in one process.

Both run the same seeded torch model on the CPU: the reference's
frontend in a one-process job (its 8-device mesh), the port's in a
1-rank gloo world, so every collective is the identity on each side and
what is compared is the frontend's contract: op and average handling,
handles with poll / synchronize (a handle consumed once), the in-place
forms, 0-d tensors, compression keeping the dtype, and the optimizers —
``DistributedOptimizer`` with 1 and 2 backward passes a step, the Adasum
delta optimizer, the parameter, optimizer-state and object broadcasts —
each leaving the same parameters after the same steps (to 1e-6).  The
port's frontend across 4 ranks: ``tests/test_torch_wire.py``; the
reference's ResNet benchmark through it: ``test_benchmark_runs_on_cpu``.
"""

import numpy as np
import pytest
import torch

import horovod_tpu as hvd
import horovod_tpu.torch as ref
import horovod_tpu_torch.torch as port
from horovod_tpu_torch import core


@pytest.fixture()
def worlds(monkeypatch, cpu_devices):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(devices=cpu_devices, local_size=4)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()
    hvd.shutdown()


@pytest.mark.parametrize("kw", [{}, {"op": "Sum"}, {"average": False},
                                {"average": True}, {"op": "Max"},
                                {"op": "Min"}, {"op": "Adasum"},
                                {"compression": "fp16"}])
def test_allreduce_forms_match_reference(worlds, kw):
    t = torch.randn(3, 2, generator=torch.Generator().manual_seed(1))
    if "compression" in kw:
        kw = {"compression": getattr(ref.Compression, kw["compression"])}
        pkw = {"compression": port.Compression.fp16}
    else:
        pkw = kw
    want = ref.allreduce(t, **kw)
    got = port.allreduce(t, **pkw)
    assert got.dtype == want.dtype == t.dtype
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_op_and_average_are_exclusive(worlds):
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.allreduce(torch.ones(3), average=True, op=mod.Sum)


def test_handles_poll_and_synchronize(worlds):
    t = torch.arange(4.0)
    for mod in (ref, port):
        h = mod.allreduce_async(t, op=mod.Sum)
        while not mod.poll(h):
            pass
        np.testing.assert_array_equal(mod.synchronize(h).numpy(), t.numpy())
        with pytest.raises(ValueError):
            mod.synchronize(h)       # consumed
        with pytest.raises(ValueError):
            mod.poll(h)
    h = port.allgather_async(t[None])
    np.testing.assert_array_equal(port.synchronize(h).numpy(), t[None])
    h = port.broadcast_async_(t.clone(), 0)
    assert torch.equal(port.synchronize(h), t)


def test_in_place_and_zero_dim_forms(worlds):
    for mod in (ref, port):
        t = torch.full((3,), 2.0)
        assert mod.allreduce_(t) is t and t.tolist() == [2.0] * 3
        s = torch.tensor(7)
        out = mod.broadcast(s, 0)
        assert out.shape == torch.Size([]) and int(out) == 7
        a = mod.allreduce(torch.tensor(3.0), op=mod.Sum)
        assert a.shape == torch.Size([]) and float(a) == 3.0
        s2 = torch.tensor(1)
        mod.broadcast_(s2, 0)
        assert s2.shape == torch.Size([]) and int(s2) == 1
        g = mod.allgather(torch.ones(2, 3))
        assert g.shape == (2, 3)
    h = port.allreduce_async_(torch.ones(2), op=port.Sum)
    assert port.synchronize(h).tolist() == [1.0, 1.0]


def _model(seed: int):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.ReLU(),
                               torch.nn.Linear(4, 3))


@pytest.mark.parametrize("case", ["sgd", "bpps2", "fp16", "adasum",
                                  "adam"])
def test_optimizers_match_reference(worlds, case):
    """4 steps of each wrapper on the same seeded model and data."""
    x = torch.randn(6, 5, generator=torch.Generator().manual_seed(2))
    y = torch.randn(6, 3, generator=torch.Generator().manual_seed(3))
    results = []
    for mod in (ref, port):
        model = _model(7)
        base = torch.optim.Adam(model.parameters(), lr=1e-2) \
            if case == "adam" else torch.optim.SGD(
                model.parameters(), lr=0.1, momentum=0.9)
        kw = {"backward_passes_per_step": 2} if case == "bpps2" else {}
        if case == "fp16":
            kw["compression"] = mod.Compression.fp16
        if case == "adasum":
            kw["op"] = mod.Adasum
        opt = mod.DistributedOptimizer(
            base, named_parameters=model.named_parameters(), **kw)
        mod.broadcast_parameters(model.state_dict(), root_rank=0)
        mod.broadcast_optimizer_state(opt, root_rank=0)
        for _ in range(4):
            opt.zero_grad()
            torch.nn.functional.mse_loss(model(x), y).backward()
            opt.step()
        results.append([p.detach().clone() for p in model.parameters()])
        assert mod.broadcast_object({"lr": 0.1}, 0, name="hp") == {"lr": 0.1}
    for got, want in zip(results[1], results[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_hand_set_gradient_is_reduced_in_synchronize(worlds):
    scale = torch.nn.Parameter(torch.tensor(2.0))
    opt = port.DistributedOptimizer(torch.optim.SGD([scale], lr=0.1),
                                    named_parameters=[("scale", scale)])
    scale.grad = torch.tensor(3.0)           # no backward: no hook fired
    opt.step()
    assert scale.shape == torch.Size([])
    assert float(scale) == pytest.approx(2.0 - 0.1 * 3.0)


def test_optimizer_state_broadcast_round_trips(worlds):
    model = _model(1)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.randn(2, 5)).sum().backward()
    opt.step()
    before = {k: {n: v.clone() if torch.is_tensor(v) else v
                  for n, v in s.items()} for k, s in opt.state.items()}
    port.broadcast_optimizer_state(opt, root_rank=0)
    for k, s in opt.state.items():
        for n, v in s.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(before[k][n]))


def test_benchmark_runs_on_cpu(monkeypatch):
    """The reference's harness at a smoke size through the port's
    frontend: a finite loss and a rate."""
    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as pb

    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    try:
        for extra in ([], ["--fp16-allreduce"]):
            out = pb.run(pb.parse_args([
                "--model", "resnet18", "--batch-size", "2", "--image-size",
                "32", "--num-classes", "10", "--num-warmup-batches", "1",
                "--num-batches-per-iter", "1", "--num-iters", "1",
                "--device", "cpu"] + extra))
            assert np.isfinite(out["final_loss"]) and \
                out["img_sec_per_proc"] > 0
            core.shutdown()
    finally:
        core.shutdown()


def test_benchmark_defaults_are_the_references():
    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as pb

    a = pb.parse_args([])
    assert (a.model, a.batch_size, a.image_size, a.num_classes,
            a.fp16_allreduce, a.num_warmup_batches, a.num_batches_per_iter,
            a.num_iters) == ("resnet50", 32, 224, 1000, False, 2, 3, 3)


@pytest.mark.parametrize("name", ["smallconv", "resnet18", "resnet50"])
def test_benchmark_models_match_the_references(name):
    """The port's copy of the reference's plain-torch models: the same
    layers, parameter shapes and, from the same seed, the same
    weights."""
    import importlib.util
    from pathlib import Path

    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as pb

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "pytorch_synthetic_benchmark.py"
    spec = importlib.util.spec_from_file_location("_ref_pt_bench", path)
    ref_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_bench)
    torch.manual_seed(42)
    want = ref_bench._make_model(name, 10).state_dict()
    torch.manual_seed(42)
    got = pb.make_model(name, 10).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
