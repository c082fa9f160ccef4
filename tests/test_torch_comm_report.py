"""horovod_tpu_torch.timeline.comm_report against
horovod_tpu.timeline.comm_report: the α–β link model.

Both sides are given the same explicit link values (the defaults differ
by design: the port's are the H100's NVLink 4 and NDR InfiniBand, the
reference's a TPU's), and every number agrees to 1e-12 relative.  The
port's ``collective_report`` reads the train step's own bucket plan and
traced collectives (it has no HLO) and returns the reference's dict.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.timeline import comm_report as ref
from horovod_tpu_torch import core, metrics, training
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.ops.fusion import FusionPlan
from horovod_tpu_torch.optim.fused_update import fused_sgd
from horovod_tpu_torch.timeline import comm_report as port

#: explicit link values both sides are given
LINKS = {"ici_bytes_per_sec": 120e9, "ici_hop_latency": 1.7e-6,
         "dcn_bytes_per_sec": 21e9, "dcn_hop_latency": 7.5e-6}
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute", "broadcast")


def _rel(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("compression", [None, "bf16", "int8", "fp8",
                                         "ef_int8"])
def test_predict_collective_us_matches_reference(compression, two_level):
    for op in OPS:
        for nbytes in (1, 4096, 3 << 20, 1 << 28):
            for world, local in ((2, None), (8, 4), (6, 2), (16, 1)):
                kw = dict(LINKS, calls=3, compression=compression,
                          orig_itemsize=2 if nbytes % 3 else 4,
                          two_level=two_level, local_size=local)
                a = port.predict_collective_us(op, nbytes, world, **kw)
                b = ref.predict_collective_us(op, nbytes, world, **kw)
                assert _rel(a, b), (op, nbytes, world, a, b)


def test_compression_terms_match_reference():
    for comp in (None, "none", "bf16", "fp16", "int8", "fp8", "fp8_e4m3",
                 "fp8_e5m2", "ef_int8"):
        for itemsize in (1, 2, 4):
            assert port.compression_wire_ratio(comp, itemsize) == \
                ref.compression_wire_ratio(comp, itemsize)
            assert port.compression_terms_us(comp, 5 << 20, 8, 1.3,
                                             itemsize) == \
                ref.compression_terms_us(comp, 5 << 20, 8, 1.3, itemsize)
        assert port.compression_overhead_us(7 << 20, comp) == \
            ref.compression_overhead_us(7 << 20, comp)
        assert port.compression_scale_exchange(comp) == \
            ref.compression_scale_exchange(comp)
    with pytest.raises(ValueError, match="no cost curve"):
        port.compression_wire_ratio("int3")


@pytest.mark.parametrize("policy", ["off", "on", "auto"])
def test_topology_spec_matches_reference(policy):
    kw = dict(world=16, local_size=4, ici_bytes_per_sec=90e9,
              ici_hop_latency_us=2.0, dcn_bytes_per_sec=12e9,
              dcn_hop_latency_us=9.0, two_level=policy)
    a, b = port.TopologySpec(**kw), ref.TopologySpec(**kw)
    assert a.to_dict() == b.to_dict()
    assert a.describe() == b.describe()
    for op in OPS:
        for nbytes in (1 << 10, 1 << 26):
            for comp in (None, "int8"):
                wa = a.wire_choice(op, nbytes, calls=2, compression=comp)
                wb = b.wire_choice(op, nbytes, calls=2, compression=comp)
                assert wa[0] == wb[0] and _rel(wa[1], wb[1])
    assert a.with_world(64).to_dict() == b.with_world(64).to_dict()


def test_per_tensor_table_matches_reference():
    tensors = {"g0": {"op": "all-reduce", "bytes": 4 << 20, "calls": 2},
               "g1": {"op": "all-gather", "bytes": 12345},
               "g2": {"op": "broadcast", "bytes": 0, "calls": 0}}
    measured = {"g0": 91.5, "g1": 3.25}
    kw = {"ici_bytes_per_sec": LINKS["ici_bytes_per_sec"],
          "ici_hop_latency": LINKS["ici_hop_latency"]}
    a = port.per_tensor_table(tensors, 8, measured_us=measured, **kw)
    b = ref.per_tensor_table(tensors, 8, measured_us=measured, **kw)
    assert a == b


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("compression", [None, "int8"])
def test_model_scaling_matches_reference(compression, two_level):
    cols = {"all-reduce": {"count": 7, "bytes": 102_233_128},
            "all-gather": {"count": 2, "bytes": 4096}}
    for t_compute in (None, 0.0312):
        a = port.model_scaling(cols, t_compute, compression=compression,
                               orig_itemsize=2, two_level=two_level,
                               local_size=4, **LINKS)
        b = ref.model_scaling(cols, t_compute, compression=compression,
                              orig_itemsize=2, two_level=two_level,
                              local_size=4, **LINKS)
        assert a[1] == b[1]
        for n in a[0]:
            assert _rel(a[0][n], b[0][n])


def test_link_defaults_are_the_h100s():
    """NVLink 4 at 450 GB/s a direction and 0.6 µs a hop, NDR
    InfiniBand at 50 GB/s and 2.7 µs a hop (module docstring)."""
    assert port.DEFAULT_ICI_BYTES_PER_SEC == 450e9
    assert port.DEFAULT_ICI_HOP_LATENCY == 0.6e-6
    assert port.DEFAULT_DCN_BYTES_PER_SEC == 50e9
    assert port.DEFAULT_DCN_HOP_LATENCY == 2.7e-6
    spec = port.TopologySpec(world=8)
    assert spec.ici_bytes_per_sec == 450e9 and spec.dcn_bytes_per_sec == 50e9


@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


@pytest.mark.parametrize("threshold", [1, 1 << 10, 1 << 26])
def test_collective_report_reads_the_steps_buckets(cpu_world, threshold):
    """The port's report of an MLP step: one all-reduce a bucket of the
    fusion plan over the gradients, plus the loss's all-reduce the
    capture recorded; the scaling model is model_scaling's on those
    collectives, which the reference's report computes the same way."""
    model = MLP(12, (16, 6))
    opt = fused_sgd(0.1)
    state = training.init_train_state(model, opt)
    metrics.registry.reset()
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt, threshold_bytes=threshold)
    step(state, torch.ones(4, 12), torch.zeros(4, dtype=torch.long))
    grads = list(state.params.values())
    rep = port.collective_report(grads, threshold_bytes=threshold,
                                 measured_step_seconds=0.01, **{
                                     k: LINKS[k] for k in
                                     ("ici_bytes_per_sec",
                                      "ici_hop_latency")})
    plan = FusionPlan(grads, threshold_bytes=threshold)
    nbytes = sum(p.numel() * 4 for p in grads)
    assert rep["collectives"] == {
        "all-reduce": {"count": len(plan.buckets) + 1, "bytes": nbytes + 4}}
    assert rep["total_collective_bytes"] == nbytes + 4
    want = ref.model_scaling(rep["collectives"], 0.01, **{
        k: LINKS[k] for k in ("ici_bytes_per_sec", "ici_hop_latency")})
    assert (rep["modeled_comm_seconds"], rep["scaling_model"]) == want
    assert set(rep) == {"collectives", "total_collective_bytes",
                        "flops_per_step", "assumptions",
                        "modeled_comm_seconds", "scaling_model"}
    assert rep["assumptions"]["t_compute_source"] == "measured"


def test_collective_report_named_buckets_and_flops():
    grads = [torch.zeros(10), torch.zeros(3, 3), torch.zeros(5)]
    rep = port.collective_report(
        grads, named_buckets=[["a", "c"]], names=["a", "b", "c"],
        traced={}, flops_per_step=2e12, peak_flops=1e15)
    assert rep["collectives"]["all-reduce"] == {"count": 2,
                                                "bytes": 24 * 4}
    assert math.isclose(rep["assumptions"]["t_compute_seconds"], 2e-3)
    assert all(0 < e < 1 for e in rep["scaling_model"].values())
    assert np.isfinite(list(rep["modeled_comm_seconds"].values())).all()
