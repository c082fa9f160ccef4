"""horovod_tpu_torch.metrics against horovod_tpu.metrics.

* the instrument inventory: every family's name, kind, help text, label
  names and bucket edges;
* the same registry contents give byte-equal Prometheus text and equal
  JSON snapshots (timestamps left out), on fresh registries of each
  package, and the same time-series history;
* ``payload_bytes`` takes torch dtypes with the reference's sizes;
* two drives give equal snapshots (names, labels, values; the timings —
  histogram sums and bucket placement — left out): the MLP through
  ``make_train_step`` (fused SGD, 3 steps), and a 2-rank gloo eager drive
  (``process_allreduce`` / ``process_allgather``, the frontend's
  ``allreduce``, ``join``) against the reference's process plane over
  its XLA process mesh, simulated in this process with both "ranks"
  giving rank 0's arrays (the metrics depend on shapes, not values);
* the instruments that replaced the port's plain fallback counters
  count what those counted, and the pushes land on the rendezvous
  server (the port's and the reference's) keyed by rank.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
import horovod_tpu.metrics as ref
from horovod_tpu import training as ref_training
from horovod_tpu.metrics import timeseries as ref_ts
from horovod_tpu.models.mlp import MLP as RefMLP
from horovod_tpu.optim import fused_update as ref_fu
import horovod_tpu_torch.metrics as port
from horovod_tpu_torch import core, training
from horovod_tpu_torch.convert import load_flax_variables
from horovod_tpu_torch.metrics import timeseries as port_ts
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.optim.fused_update import fused_sgd
from torch_dist_worker import eager_drive, launch, snapshot_samples
from torch_rdv import kv_env, serving

def _snapshot_samples(registry):
    """Every family with samples, the stall inspector's pull gauges
    (``hvd_inflight_ops``, ``hvd_stalled_ops``) included."""
    return snapshot_samples(registry)


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE", "HVD_TIMELINE", "HVD_TRACE_DIR"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def _inventory(registry):
    return {name: (m.kind, m.help, m.labelnames,
                   getattr(m, "buckets", None))
            for name, m in registry._metrics.items()}


def test_instrument_inventory_matches_reference():
    got, want = _inventory(port.registry), _inventory(ref.registry)
    assert got == want
    assert len(got) >= 75


def _no_times(snap):
    """A snapshot without its timestamps."""
    return {name: {k: v for k, v in fam.items() if k != "updated"}
            for name, fam in snap["metrics"].items()}


def _fill(mod, scenario):
    """The same calls on a fresh registry of ``mod`` (a metrics package)."""
    r = mod.MetricsRegistry(enabled=True)
    if scenario == "counters":
        c = r.counter("hvd_test_calls_total", "Calls by op.", ("op", "where"))
        c.labels("allreduce", "world").inc()
        c.labels(op="allgather", where='a "quoted"\\ name\n').inc(2.5)
        r.counter("hvd_test_plain_total").inc(3)
    elif scenario == "gauges":
        g = r.gauge("hvd_test_gauge", "A gauge.")
        g.set(-1.25)
        g.inc(0.5)
        r.gauge("hvd_test_big", "", ("k",)).labels("x").set(1e16)
        r.gauge("hvd_test_nan").set(float("nan"))
        r.gauge("hvd_test_inf").set(float("inf"))
    elif scenario == "histograms":
        h = r.histogram("hvd_test_seconds", "Latency.", ("op",))
        for v in (5e-5, 3e-4, 0.02, 7.0, 1e3):
            h.labels("allreduce").observe(v)
        hb = r.histogram("hvd_test_bytes", "Bytes.",
                         buckets=mod.exponential_buckets(64.0, 8.0, 4))
        for v in (1, 100, 10_000, 1 << 30):
            hb.observe(v)
    else:  # collectors
        g = r.gauge("hvd_test_polled", "Polled at snapshot.")
        r.register_collector("poll", lambda: g.set(42))
        r.register_collector("broken", lambda: 1 / 0)
    return r


@pytest.mark.parametrize("scenario",
                         ["counters", "gauges", "histograms", "collectors"])
def test_same_contents_give_byte_equal_text_and_equal_snapshots(scenario):
    rp, rr = _fill(port, scenario), _fill(ref, scenario)
    assert rp.to_prometheus() == rr.to_prometheus()
    assert rp.to_prometheus({"rank": "3"}) == rr.to_prometheus({"rank": "3"})
    sp, sr = rp.snapshot(), rr.snapshot()
    assert json.dumps(_no_times(sp), sort_keys=True) == \
        json.dumps(_no_times(sr), sort_keys=True)
    # the merged page of several ranks' snapshots
    snaps = [({"rank": str(i)}, sr) for i in range(2)]
    assert port.render_prometheus(snaps) == ref.render_prometheus(snaps)


def test_dump_and_reset_match_reference(tmp_path):
    rp, rr = _fill(port, "histograms"), _fill(ref, "histograms")
    rp.dump(str(tmp_path / "p" / "metrics.json"))
    rr.dump(str(tmp_path / "r" / "metrics.json"))
    got = json.loads((tmp_path / "p" / "metrics.json").read_text())
    want = json.loads((tmp_path / "r" / "metrics.json").read_text())
    assert _no_times(got) == _no_times(want)
    rp.reset()
    rr.reset()
    assert _no_times(rp.snapshot()) == _no_times(rr.snapshot())


def test_timeseries_ring_matches_reference():
    sp = port_ts.TimeseriesStore(enabled=True, cap=8, tiers=3, factor=2)
    sr = ref_ts.TimeseriesStore(enabled=True, cap=8, tiers=3, factor=2)
    for i in range(37):
        for s in (sp, sr):
            s.record(port_ts.STEP_SECONDS, 0.5 + (i % 5) * 0.1, step=i)
            if i % 3 == 0:
                s.record(port_ts.MFU_SERIES, i / 100)
    assert sp.snapshot() == sr.snapshot()
    assert sp.series(port_ts.STEP_SECONDS).raw_since(30) == \
        sr.series(port_ts.STEP_SECONDS).raw_since(30)
    assert port_ts.KNOWN_SERIES == ref_ts.KNOWN_SERIES
    off = port_ts.TimeseriesStore(enabled=False)
    off.record("x", 1.0)
    assert off.names() == []


@pytest.mark.parametrize("tdtype,name", [
    (torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
    (torch.float16, "float16"), (torch.float8_e4m3fn, "float8_e4m3fn"),
    (torch.float8_e5m2, "float8_e5m2"), (torch.int8, "int8"),
    (torch.int64, "int64"), (torch.bool, "bool"),
])
def test_payload_bytes_takes_torch_dtypes_with_the_references_sizes(
        tdtype, name):
    shape = (3, 5, 2)
    want = ref.payload_bytes(shape, name)
    assert want == 30 * tdtype.itemsize
    assert port.payload_bytes(shape, tdtype) == want
    assert port.payload_bytes(shape, name) == want
    assert port.payload_bytes(shape, str(tdtype)) == want
    assert port.payload_bytes(shape, np.dtype("float64")) == 240
    assert port.payload_bytes(shape, object()) == 0


def _mlp_problem():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    y = rng.integers(0, 6, size=(8,)).astype(np.int32)
    model = RefMLP(features=(16, 6))
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(3), x))
    return model, variables, x, y


def test_mlp_train_step_snapshot_matches_reference(port_cpu_world,
                                                   cpu_devices):
    model, variables, x, y = _mlp_problem()
    hvd.shutdown()
    hvd.init(devices=cpu_devices[:1])
    try:
        ref.registry.reset()
        opt = ref_fu.fused_sgd(0.1, momentum=0.9)
        step = ref_training.make_train_step(
            apply_fn=lambda v, a, train=True: model.apply(v, a),
            loss_fn=lambda lg, lb: optax.
            softmax_cross_entropy_with_integer_labels(lg, lb).mean(),
            optimizer=opt, loss_fetch_steps=0, profile=False)
        params = variables["params"]
        state = jax.device_put(ref_training.TrainState(
            params=params, opt_state=opt.init(params), model_state={},
            step=jnp.zeros((), jnp.int32)),
            NamedSharding(hvd.core.mesh(), P()))
        xs, ys = ref_training.shard_batch(x), ref_training.shard_batch(y)
        for _ in range(3):
            state, loss = step(state, xs, ys)
        jax.block_until_ready(loss)
        want = _snapshot_samples(ref.registry)
    finally:
        hvd.shutdown()

    port.registry.reset()
    pm = MLP(12, (16, 6))
    load_flax_variables(pm, variables["params"])
    popt = fused_sgd(0.1, momentum=0.9)
    pstep = training.make_train_step(apply_fn=pm, loss_fn=F.cross_entropy,
                                     optimizer=popt, loss_fetch_steps=0)
    pstate = training.init_train_state(pm, popt)
    for _ in range(3):
        pstate, _ = pstep(pstate, torch.from_numpy(x),
                          torch.from_numpy(y).long())
    got = _snapshot_samples(port.registry)
    assert got == want
    assert want["hvd_steps_total"] == [("{}", 3.0)]
    assert want["hvd_collectives_traced_total"] == \
        [('{"op": "allreduce"}', 1.0)]


def _reference_eager_drive(monkeypatch, cpu_devices):
    """The reference's process plane over its XLA process mesh as two
    processes see it, in one: both "ranks" give rank 0's arrays."""
    import horovod_tpu.torch as ref_torch
    from horovod_tpu import eager as ref_eager
    from jax.experimental import multihost_utils

    hvd.shutdown()
    hvd.init(devices=cpu_devices[:1])
    try:
        monkeypatch.setattr(hvd.core, "process_size", lambda: 2)
        monkeypatch.setattr(ref_eager, "allgather_object",
                            lambda obj, name=None: [obj, obj])
        monkeypatch.setattr(ref_eager, "_mesh_sum_rows", lambda r: r + r)
        monkeypatch.setattr(ref_eager, "_mesh_minmax_rows",
                            lambda r, kind: r)
        monkeypatch.setattr(ref_eager, "_mesh_allgather_rows",
                            lambda r: np.stack([r, r]))
        monkeypatch.setattr(multihost_utils, "sync_global_devices",
                            lambda name: None)
        ref.registry.reset()
        eager_drive(ref_eager, ref_torch, 0)
        return _snapshot_samples(ref.registry)
    finally:
        monkeypatch.undo()
        hvd.shutdown()


def test_two_rank_eager_drive_matches_reference_process_plane(
        tmp_path, monkeypatch, cpu_devices):
    want = _reference_eager_drive(monkeypatch, cpu_devices)
    launch("trace", 2, tmp_path)
    got = json.loads(str(np.load(tmp_path / "trace.0.npz")["metrics"]))
    assert {k: [tuple(s) for s in v] for k, v in got.items()} == want
    assert dict(want["hvd_host_collective_calls_total"]) == {
        '{"op": "allgather", "transport": "mesh"}': 1.0,
        '{"op": "allreduce", "transport": "mesh"}': 4.0}
    assert want["hvd_join_events_total"] == [("{}", 1.0)]


def test_fallback_instruments_count_what_the_counters_counted(
        port_cpu_world):
    from horovod_tpu_torch.ops import compression
    from horovod_tpu_torch.parallel import hierarchical

    comp, two = (port.COMPRESSION_FALLBACKS.get(),
                 port.TWO_LEVEL_FALLBACKS.get())
    # a quantizer over a group that leaves it under 2 levels ships
    # uncompressed (int8 over 100 ranks), once a call
    compression.Int8Compressor.compress_for(torch.ones(4), 100)
    compression.Int8Compressor.compress_for(torch.ones(4), 100)
    # at one rank the two-level all-reduce falls back to the flat one
    hierarchical.two_level_allreduce(torch.ones(5))
    assert port.COMPRESSION_FALLBACKS.get() == comp + 2
    assert port.TWO_LEVEL_FALLBACKS.get() == two + 1
    assert not hasattr(compression, "FALLBACKS")
    assert not hasattr(hierarchical, "FALLBACKS")


def test_traced_inventory_is_recorded_once_a_capture(port_cpu_world):
    from horovod_tpu_torch.ops import collectives

    port.registry.reset()
    x = torch.ones(3)
    collectives.allreduce(x)              # outside a step: every call
    collectives.allreduce(x)
    with port.traced_recording(False):    # a step's later executions
        collectives.allreduce(x)
        collectives.allgather(x)
    with port.traced_recording(True):     # its recorded one
        collectives.broadcast(x)
    assert port.TRACED_CALLS.get("allreduce") == 2
    assert port.TRACED_BYTES.get("allreduce") == 24
    assert port.TRACED_CALLS.get("broadcast") == 1
    assert port.TRACED_CALLS.get("allgather") == 0


@pytest.mark.parametrize("env", [{"server": "port"},
                                 {"server": "reference"}])
def test_rendezvous_pushes_raise(monkeypatch, env):
    """Named for what it held before the rendezvous plane was ported (the
    pushes raised); now the pusher and the time-series flusher land on
    the port's server (env0) and the reference's (env1) under the rank
    they were started with, and ``core.init`` starts both keyed by this
    process's ``HVD_PROCESS_ID``."""
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_TRACE_DIR", "HVD_TIMELINE"):
        monkeypatch.delenv(k, raising=False)
    with serving(env["server"]) as srv:
        kv_env(monkeypatch, srv)
        assert port.start_pusher_from_env(3) is not None
        assert port_ts.start_flusher_from_env(3) is not None
        port.STEPS_TOTAL.inc()
        port_ts.record("step_seconds", 0.5, step=1)
        port.stop_pusher()       # each stop pushes once more
        port_ts.stop_flusher()
        pushed = json.loads(srv.get("metrics", "3"))["metrics"]
        assert pushed["hvd_steps_total"]["samples"][0]["value"] == \
            port.STEPS_TOTAL.get()
        assert "step_seconds" in json.loads(
            srv.get("timeseries", "3"))["series"]
        core.shutdown()
        core.init(device="cpu")
        core.shutdown()
        assert srv.get("metrics", "0") is not None
        assert srv.get("timeseries", "0") is not None
    assert not core.is_initialized()


def test_without_rendezvous_the_pushes_are_off(monkeypatch):
    for k in ("HVD_METRICS_KV_ADDR", "HVD_METRICS_KV_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert port.start_pusher_from_env(0) is None
    assert port_ts.start_flusher_from_env(0) is None
