"""horovod_tpu_torch.observe.events (the flight recorder) against
horovod_tpu.observe.events: the same calls give the reference's event
dicts (ids ``<host>-<pid>-<seq>`` — one process, so the same ids), ring
cap and drop counts, correlation chains, metrics, and chain extraction
over the reference's fixture corpus; the error-feedback guard's trip
records ``compression.fallback`` as the reference's does.  The sinks
land events in the rendezvous server's ``events`` scope (the port's and
the reference's): the worker's flusher and the launcher's attached
recorder."""

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
import horovod_tpu.metrics as ref_metrics
import horovod_tpu.observe.events as ref
from horovod_tpu import training as ref_training
from horovod_tpu.models.mlp import MLP as RefMLP
from horovod_tpu.observe.fixtures import events_fixture
from horovod_tpu.optim import fused_update as ref_fu
import horovod_tpu_torch.metrics as port_metrics
import horovod_tpu_torch.observe.events as port
from horovod_tpu_torch import core, training
from horovod_tpu_torch.convert import (
    canonical_layouts, flatten_flax, load_flax_variables,
)
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.optim.fused_update import fused_sgd


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("HVD_METRICS_KV_ADDR", "HVD_METRICS_KV_PORT", "HVD_EVENTS"):
        monkeypatch.delenv(k, raising=False)
    port._reset_for_tests()
    ref._reset_for_tests()
    yield
    port._reset_for_tests()
    ref._reset_for_tests()


def _no_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _chain_calls(rec):
    root = rec.record("lease.expired", severity="critical", rank=2,
                      payload={"rank": 2})
    mid = rec.record("epoch.remove", cause_id=root, payload={"rank": 2})
    leaf = rec.record("abort.publish", cause_id=mid, severity="warning")
    rec.record("abort.observe", correlation_id="launcher-7-0",
               cause_id="launcher-7-3")
    rec.record("checkpoint.save", payload={"step": 10})
    rec.record("restart.resume", cause_id=leaf, payload={"steps_lost": 3})
    return rec.drain()


def test_recorder_events_equal_the_references():
    got = _chain_calls(port.Recorder(cap=64))
    want = _chain_calls(ref.Recorder(cap=64))
    assert _no_ts(got) == _no_ts(want)
    assert got[1]["correlation_id"] == got[0]["id"]
    assert got[2]["correlation_id"] == got[0]["id"]   # transitively
    assert got[0]["id"].rsplit("-", 2)[1:] == [got[0]["id"].split("-")[-2],
                                               "0"]


@pytest.mark.parametrize("cap,n", [(4, 10), (8, 8), (3, 1)])
def test_ring_cap_drops_and_counts_as_the_reference(cap, n):
    out = {}
    for name, mod, met in (("port", port, port_metrics),
                           ("ref", ref, ref_metrics)):
        before = met.EVENTS_DROPPED.get()
        total = met.EVENTS_TOTAL.get("epoch.commit", "info")
        r = mod.Recorder(cap=cap)
        ids = [r.record("epoch.commit", payload={"n": i}) for i in range(n)]
        batch = r.drain()
        r.record("epoch.admit")
        r.requeue(batch)
        out[name] = (ids, r.dropped, r.recorded, _no_ts(r.drain()),
                     met.EVENTS_DROPPED.get() - before,
                     met.EVENTS_TOTAL.get("epoch.commit", "info") - total)
    assert out["port"] == out["ref"]
    assert out["port"][4] == max(n - cap, 0) + max(min(n, cap) + 1 - cap, 0)


def test_record_event_api_and_correlation_of_match_the_reference():
    got, want = [], []
    for mod, out in ((port, got), (ref, want)):
        a = mod.record_event("autotune.apply", payload={"plan": 1})
        b = mod.record_event("autotune.verify", cause_id=a)
        out.append((mod.correlation_of(b), mod.correlation_of(None),
                    mod.correlation_of("nowhere")))
        out.extend(_no_ts(mod.recorder().drain()))
    assert got == want
    assert port.KNOWN_KINDS == ref.KNOWN_KINDS
    assert port.EVENTS_SCOPE == ref.EVENTS_SCOPE


def test_recorder_off_records_nothing(monkeypatch):
    monkeypatch.setenv("HVD_EVENTS", "0")
    assert port.record_event("epoch.commit") is None
    assert ref.record_event("epoch.commit") is None


@pytest.mark.parametrize("entry", ["worker2-9-1", "launcher-1-2",
                                   "launcher-1-0", "launcher-1-4", "none"])
def test_chain_extraction_equals_the_references(entry):
    fx = events_fixture()
    got, want = port.extract_chain(fx, entry), ref.extract_chain(fx, entry)
    assert got == want
    assert port.chain_summary(got) == ref.chain_summary(want)


def _mlp_problem():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    y = rng.integers(0, 6, size=(8,)).astype(np.int32)
    model = RefMLP(features=(16, 6))
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(3), x))
    return model, variables, x, y


#: the guard reads every GUARD_STEPS calls and takes its baseline from
#: its first 3 reads; the residual is blown up before call TRIP_AFTER + 1,
#: whose read trips
GUARD_STEPS, TRIP_AFTER = 2, 7


def _blown_residual(params) -> dict:
    """A residual 1e7 times any gradient, seeded, flax layout by path."""
    rng = np.random.default_rng(0)
    return {k: rng.normal(size=v.shape).astype(np.float32) * 1e7
            for k, v in flatten_flax(params).items()}


def _reference_guard_trip(cpu_devices):
    from horovod_tpu.ops.compression import Compression as RefCompression

    model, variables, x, y = _mlp_problem()
    hvd.shutdown()
    hvd.init(devices=cpu_devices[:1])
    try:
        opt = ref_fu.fused_sgd(0.1, momentum=0.9)
        step = ref_training.make_train_step(
            apply_fn=lambda v, a, train=True: model.apply(v, a),
            loss_fn=lambda lg, lb: optax.
            softmax_cross_entropy_with_integer_labels(lg, lb).mean(),
            optimizer=opt, loss_fetch_steps=0, profile=False,
            compression=RefCompression.lookup("ef_int8"))
        params = variables["params"]
        state = jax.device_put(ref_training.TrainState(
            params=params, opt_state=opt.init(params), model_state={},
            step=jnp.zeros((), jnp.int32),
            residual=jax.tree_util.tree_map(jnp.zeros_like, params)),
            NamedSharding(hvd.core.mesh(), P()))
        xs, ys = ref_training.shard_batch(x), ref_training.shard_batch(y)
        for i in range(TRIP_AFTER + 1):
            if i == TRIP_AFTER:
                _, treedef = jax.tree_util.tree_flatten(state.residual)
                big = _blown_residual(params)
                state = state._replace(residual=jax.device_put(
                    jax.tree_util.tree_unflatten(treedef, list(big.values())),
                    NamedSharding(hvd.core.mesh(), P())))
            state, _ = step(state, xs, ys)
        return ref.recorder().drain()
    finally:
        hvd.shutdown()


def _port_guard_trip():
    from horovod_tpu_torch.ops.compression import Compression

    _, variables, x, y = _mlp_problem()
    model = MLP(12, (16, 6))
    load_flax_variables(model, variables["params"])
    opt = fused_sgd(0.1, momentum=0.9)
    comp = Compression.lookup("ef_int8")
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt, compression=comp,
                                    loss_fetch_steps=0)
    state = training.init_train_state(model, opt, compression=comp)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    for i in range(TRIP_AFTER + 1):
        if i == TRIP_AFTER:
            big = _blown_residual(variables["params"])
            layouts = canonical_layouts(model)
            with torch.no_grad():
                for k, r in state.residual.items():
                    r.copy_(torch.from_numpy(layouts[k].to_torch(big[k])))
        state, _ = step(state, xt, yt)
    assert step.guard["trips"] == 1
    return port.recorder().drain()


def test_guard_fallback_records_the_references_event(monkeypatch,
                                                     cpu_devices):
    monkeypatch.setenv("HVD_COMPRESSION_GUARD_STEPS", str(GUARD_STEPS))
    want = _reference_guard_trip(cpu_devices)
    core.shutdown()
    core.init(device="cpu")
    try:
        before = port_metrics.COMPRESSION_FALLBACKS.get()
        got = _port_guard_trip()
        assert port_metrics.COMPRESSION_FALLBACKS.get() == before + 1
        assert port_metrics.COMPRESSION_RESIDUAL_NORM.get() > 1e6
    finally:
        core.shutdown()
    assert [e["kind"] for e in got] == [e["kind"] for e in want] == \
        ["compression.fallback"]
    (g,), (w,) = got, want
    assert (g["severity"], g["rank"], g["cause_id"]) == \
        (w["severity"], w["rank"], w["cause_id"]) == ("warning", None, None)
    assert g["correlation_id"] == g["id"]
    assert sorted(g["payload"]) == sorted(w["payload"]) == \
        ["factor", "residual_norm", "step"]
    assert g["payload"]["factor"] == w["payload"]["factor"]
    assert g["payload"]["step"] == w["payload"]["step"]
    np.testing.assert_allclose(g["payload"]["residual_norm"],
                               w["payload"]["residual_norm"], rtol=1e-5)


@pytest.mark.parametrize("env", [{"server": "port"},
                                 {"server": "reference"}])
def test_the_rendezvous_sinks_raise(monkeypatch, env):
    """Named for what it held before the rendezvous plane was ported (the
    sinks raised); now both land events in the ``events`` scope of the
    port's server (env0) and the reference's (env1): a worker's flusher
    through ``PUT /batch``, the launcher's recorder attached in
    process."""
    from torch_rdv import kv_env, serving

    port._reset_for_tests()
    try:
        with serving(env["server"]) as srv:
            kv_env(monkeypatch, srv)
            eid = port.record_event("epoch.commit", payload={"epoch": 1})
            assert port.recorder()._flusher is not None
            port.flush()
            assert port.recorder().pending() == 0
            got = srv.events_report()["events"]
            assert [e["kind"] for e in got if e["id"] == eid] == \
                ["epoch.commit"]
            port._reset_for_tests()
            port.attach_server(srv)
            eid = port.record_event("restart.attempt", cause_id=eid)
            assert json.loads(srv.get("events", eid))["cause_id"] is not None
            assert port.recorder().pending() == 0
    finally:
        port._reset_for_tests()


