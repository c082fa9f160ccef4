"""The port's pushes to the launcher's rendezvous server, each against
the port's server and the reference's (``torch_rdv.serving``).

* The MLP through ``make_train_step(profile=True)`` in a world joined
  with ``HVD_METRICS_KV_*`` and ``HVD_TRACE_DIR`` set: ``core.init``
  starts the metrics pusher and the time-series flusher keyed by this
  process's rank and runs the timeline's clock handshake
  (``clock_sync.json`` beside ``comm.json``, its offset within its round
  trip of the server's clock); the profiler's window pushes its anatomy
  (``GET /profile``); the flight recorder's flusher lands an event
  (``GET /events``); ``shutdown`` pushes the final snapshot, whose step
  counter is the registry's.
* ``HVD_RELAY=1``: ``core.init`` stands up the host's relay, the
  time-series push rides it and ``shutdown`` flushes it upstream.
* The time-series flusher's arm poll (``observe/arm``) moves the
  timeline's window, as the reference's does.
* The clock handshake against a live server, through either package's
  client, agrees with the server's clock within its round trip.
"""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch import core, metrics, training
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.observe import autoarm, events
from horovod_tpu_torch.optim.fused_update import fused_sgd
from horovod_tpu_torch.timeline.replay import clock
from horovod_tpu_torch.timeline.timeline import timeline
from torch_rdv import SECRET, kv_env, serving

_ENV = ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
        "HVD_LOCAL_SIZE", "HVD_TIMELINE", "HVD_TRACE_DIR", "HVD_PROFILE",
        "HVD_PROFILE_XLA", "HVD_TRACE_START_STEP", "HVD_TRACE_END_STEP",
        "HVD_PROFILE_START_STEP", "HVD_PROFILE_END_STEP",
        "HVD_METRICS_KV_ADDR", "HVD_METRICS_KV_PORT", "HVD_METRICS_SECRET",
        "HVD_RENDEZVOUS_ADDRS", "HVD_RELAY")


@pytest.fixture()
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    events._reset_for_tests()
    yield
    core.shutdown()
    events._reset_for_tests()


def _train(steps: int) -> list:
    torch.manual_seed(0)
    model = MLP(12, (16, 6))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(8, 12, generator=gen)
    y = torch.randint(0, 6, (8,), generator=gen)
    opt = fused_sgd(0.1, momentum=0.9)
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt, loss_fetch_steps=0,
                                    profile=True)
    state = training.init_train_state(model, opt)
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, y)
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize("server", ["port", "reference"])
def test_the_mlp_step_pushes_to_the_server(clean_env, tmp_path, monkeypatch,
                                           server):
    with serving(server) as srv:
        kv_env(monkeypatch, srv)
        monkeypatch.setenv("HVD_TRACE_DIR", str(tmp_path))
        monkeypatch.setenv("HVD_PROFILE_START_STEP", "2")
        monkeypatch.setenv("HVD_PROFILE_END_STEP", "3")
        monkeypatch.setenv("HVD_METRICS_PUSH_SECONDS", "600")
        core.init(device="cpu")
        losses = _train(4)
        eid = events.record_event("test.push", payload={"losses": 4})
        events.flush()
        core.shutdown()
        steps = metrics.STEPS_TOTAL.get()
        snap = json.loads(srv.get("metrics", "0"))
        hist = json.loads(srv.get("timeseries", "0"))
        profile = srv.profile_report()
        evs = srv.events_report()["events"]
    assert np.isfinite(losses).all()
    # the final snapshot, keyed by this process's rank
    assert snap["metrics"]["hvd_steps_total"]["samples"][0]["value"] == steps
    # the loss gauge: the profiled window's last step (calls 2-3)
    assert snap["metrics"]["hvd_train_loss"]["samples"][0]["value"] == \
        pytest.approx(losses[2])
    # the cadence series (from the second call, as the reference's)
    assert len(hist["series"]["step_seconds"]["samples"]) >= 3
    # the profiler window's anatomy, and the cross-rank aggregate over it
    assert sorted(profile["ranks"]) == ["0"]
    assert profile["ranks"]["0"]["steps"] == 2
    assert sorted(profile["aggregate"]["segments"]) == sorted(
        profile["ranks"]["0"]["segments"])
    assert [e for e in evs if e["id"] == eid][0]["kind"] == "test.push"
    # the clock handshake's sidecar beside comm.json
    sync = json.loads((tmp_path / "0" / "clock_sync.json").read_text())
    assert (tmp_path / "0" / "comm.json").exists()
    assert sync["rank"] == 0 and sync["samples"] >= 1
    assert math.isfinite(sync["offset_us"]) and sync["rtt_us"] >= 0


@pytest.mark.parametrize("server", ["port", "reference"])
def test_init_stands_up_the_relay_and_the_pushes_ride_it(clean_env,
                                                        monkeypatch,
                                                        server):
    """``HVD_RELAY=1`` on local rank 0: ``core.init`` starts the host's
    relay and announces it under ``relay/<host>``; the time-series push
    goes through it, and ``shutdown`` flushes it upstream."""
    from horovod_tpu_torch.run import relay

    with serving(server) as srv:
        kv_env(monkeypatch, srv)
        monkeypatch.setenv("HVD_RELAY", "1")
        monkeypatch.setenv("HVD_METRICS_PUSH_SECONDS", "600")
        core.init(device="cpu")
        daemon = relay.instance()
        try:
            assert daemon is not None
            record = json.loads(srv.get(relay.RELAY_SCOPE,
                                        relay.host_slug()))
            assert record["port"] == daemon.port
            metrics.STEPS_TOTAL.inc(2)
        finally:
            core.shutdown()
        assert relay.instance() is None
        # the time series' final push rode the relay's batch; the metrics
        # pusher's final snapshot goes to the server directly
        # (push_snapshot), as the reference's does
        assert daemon.flushes >= 1 and daemon.entries_flushed >= 1
        snap = json.loads(srv.get("metrics", "0"))
        assert snap["metrics"]["hvd_steps_total"]["samples"][0]["value"] \
            == metrics.STEPS_TOTAL.get()
        assert srv.get("timeseries", "0") is not None


@pytest.mark.parametrize("server", ["port", "reference"])
def test_the_flushers_arm_poll_moves_the_window(clean_env, tmp_path,
                                                monkeypatch, server):
    from horovod_tpu_torch.metrics import timeseries

    autoarm.reset()
    timeseries.store.reset()
    # this rank is at training step 3: the global window 5-6 lands on
    # the timeline's own calls 2-3 (its counter starts at the arm)
    timeseries.record(timeseries.STEP_SECONDS, 0.1, step=3)
    with serving(server) as srv:
        record = autoarm.make_arm_record("arm-1", 5, 6, "step_time",
                                         str(tmp_path))
        srv.put(autoarm.ARM_SCOPE, autoarm.ARM_KEY,
                json.dumps(record).encode())
        try:
            assert autoarm.poll_and_apply("127.0.0.1", srv.port,
                                          secret=SECRET)
            assert timeline.active
            assert (timeline._start_step, timeline._end_step) == (2, 3)
            # once per arm id
            assert not autoarm.poll_and_apply("127.0.0.1", srv.port,
                                              secret=SECRET)
        finally:
            timeline.shutdown()
            autoarm.reset()


@pytest.mark.parametrize("server", ["port", "reference"])
def test_the_clock_handshake_against_a_server(server):
    with serving(server) as srv:
        est = clock.estimate_offset("127.0.0.1", srv.port, secret=SECRET,
                                    samples=4)
        local = clock._default_clock_us()
        server_now = srv_clock(srv)
    # both clocks are this process's perf_counter: the offset is the
    # server clock's origin against the local one, within the round trip
    assert est["samples"] == 4 and est["rtt_us"] >= 0
    assert abs((local + est["offset_us"]) - server_now) < \
        est["rtt_us"] / 2 + 1e6


def srv_clock(srv) -> float:
    from horovod_tpu_torch.run.http_client import get_clock

    return get_clock("127.0.0.1", srv.port, secret=SECRET)
