"""The port's watchdog (``horovod_tpu_torch/observe/{detectors,invariants,
fixtures,watchdog,watch}.py``, ``autoarm.broadcast_arm`` and the dormant
profiler of ``make_train_step``) held to the reference's on the CPU.

* The hand-computed pins: ``WATCH_EXPECTED``, ``EVENTS_EXPECTED`` and
  ``CHAOS_EXPECTED`` hit exactly by the port's detectors, chain walk and
  invariants, and equal to what the reference's compute on the same
  fixtures; every detector exact on seeded series; ``observe.watch
  --check`` in process.
* ``Watchdog.tick()`` over the port's server publishes the same alerts
  (signal, severity, evidence, window, armed window; timestamps aside)
  as the reference's over the same pushed series, and holds them in its
  cooldown; a critical straggler is evicted under ``HVD_WATCH_EVICT``
  only; ``start_from_env`` starts it by default, ``HVD_WATCH=0`` not.
* An arm record broadcast on the port's server reaches a step's dormant
  profiler, which profiles the window's calls; ``HVD_WATCH_ARM=0``
  leaves the step without one.  Every tick is driven directly.
"""

import gc
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.observe import detectors as ref_detectors
from horovod_tpu.observe import fixtures as ref_fixtures
from horovod_tpu.observe.watchdog import Watchdog as RefWatchdog
from horovod_tpu.run.http_server import RendezvousServer as RefServer
from horovod_tpu_torch import core, training
from horovod_tpu_torch.metrics import timeseries
from horovod_tpu_torch.models.mlp import MLP
from horovod_tpu_torch.observe import autoarm, detectors, fixtures, watch
from horovod_tpu_torch.observe import watchdog as watchdog_mod
from horovod_tpu_torch.observe.watchdog import Watchdog
from horovod_tpu_torch.optim.fused_update import fused_sgd
from horovod_tpu_torch.run.http_server import RendezvousServer

SECRET = b"watch-secret"


@pytest.fixture()
def servers():
    ours, theirs = RendezvousServer(secret=SECRET), RefServer(secret=SECRET)
    ours.start()
    theirs.start()
    autoarm.reset()
    yield ours, theirs
    autoarm.reset()
    ours.stop()
    theirs.stop()


# -- the pins ----------------------------------------------------------------
def test_watch_fixture_pins_match_reference():
    got = fixtures.evaluate_fixture()
    assert got == ref_fixtures.evaluate_fixture()
    exp = fixtures.WATCH_EXPECTED
    assert exp == ref_fixtures.WATCH_EXPECTED
    reg = got["regression"]
    assert reg["severity"] == exp["regression"]["severity"]
    assert reg["evidence"]["fired_step"] == exp["regression"]["fired_step"]
    for k in ("baseline_median", "baseline_mad", "threshold", "ewma"):
        assert reg["evidence"][k] == pytest.approx(exp["regression"][k],
                                                   abs=1e-6)
    for name in ("straggler", "mfu", "beta", "burn"):
        assert got[name]["severity"] == exp[name]["severity"]
        for k, v in exp[name].items():
            if k != "severity":
                assert got[name]["evidence"][k] == pytest.approx(v,
                                                                 abs=1e-6)
    assert got["quiet"] == []


def test_events_and_chaos_pins_match_reference():
    assert fixtures.evaluate_events_fixture() == fixtures.EVENTS_EXPECTED \
        == ref_fixtures.evaluate_events_fixture()
    got, ref = fixtures.evaluate_chaos_fixture(), \
        ref_fixtures.evaluate_chaos_fixture()
    assert {k: got[k] for k in fixtures.CHAOS_EXPECTED} == \
        fixtures.CHAOS_EXPECTED == ref_fixtures.CHAOS_EXPECTED
    assert [v.to_dict() for v in got["violations"]] == \
        [v.to_dict() for v in ref["violations"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detectors_match_reference_on_seeded_series(seed):
    rng = np.random.RandomState(seed)
    n = 64
    base = list(0.1 + 0.002 * rng.randn(n))
    jump = int(rng.randint(20, 50))
    series = [(i + 1, v * (1.6 if i >= jump else 1.0))
              for i, v in enumerate(base)]
    ranks = {str(r): [(i + 1, float(v) * (1.5 if r == 2 else 1.0))
                      for i, v in enumerate(0.1 + 0.01 * rng.rand(16))]
             for r in range(4)}
    mfu = [(i + 1, float(v)) for i, v in enumerate(
        np.r_[0.4 + 0.01 * rng.randn(12), 0.25 + 0.01 * rng.randn(12)])]
    p99 = [(i + 1, float(v)) for i, v in enumerate(rng.uniform(50, 300, 40))]
    for mod_a, mod_b in ((detectors, ref_detectors),):
        assert mod_a.ewma_mad_regression(series, warmup=16) == \
            mod_b.ewma_mad_regression(series, warmup=16)
        assert mod_a.straggler_drift(ranks) == mod_b.straggler_drift(ranks)
        assert mod_a.mfu_drop(mfu) == mod_b.mfu_drop(mfu)
        assert mod_a.comm_beta_drift(p99, 40.0) == \
            mod_b.comm_beta_drift(p99, 40.0)
        assert mod_a.slo_burn_rate(p99, 250.0) == \
            mod_b.slo_burn_rate(p99, 250.0)
        block = {"ranks": {"1": {"verdict": "straggler", "skew": 1.45},
                           "0": {"verdict": "ok", "skew": 1.0}}}
        assert mod_a.straggler_from_verdicts(block) == \
            mod_b.straggler_from_verdicts(block)


def test_watch_cli_check_in_process(capsys):
    assert watch.run_check() == 0
    assert "regression fires at step 43" in capsys.readouterr().out


# -- the watchdog over a server ----------------------------------------------
def _push(server, rank, **series):
    doc = {"series": {name: {"samples": [[s, v] for s, v in samples],
                             "seq": len(samples),
                             "last_step": samples[-1][0]}
                      for name, samples in series.items()}}
    server.put("timeseries", str(rank), json.dumps(doc).encode())


def _strip(alert):
    return {k: v for k, v in alert.items() if k not in ("ts", "event_id")}


def test_tick_publishes_the_references_alerts(servers, monkeypatch,
                                              tmp_path):
    monkeypatch.setenv("HVD_TIMELINE", str(tmp_path))
    quiet = [(i + 1, 0.100 if i % 2 else 0.101) for i in range(48)]
    for server in servers:
        _push(server, 0, step_seconds=quiet + [(49 + i, 0.160)
                                               for i in range(8)],
              mfu=[(i + 1, 0.40 if i < 8 else 0.30) for i in range(16)])
        for rank in (1, 2):
            _push(server, rank, step_seconds=quiet,
                  serve_p99_ms=[(i + 1, 300.0 if i % 10 == 0 else 80.0)
                                for i in range(40)])
        _push(server, 3, step_seconds=[(i + 1, 0.2) for i in range(16)],
              dispatch_us_per_mib=[(i + 1, 50.0 if i < 8 else 160.0)
                                   for i in range(16)])
    ours, theirs = (Watchdog(servers[0], interval=60.0),
                    RefWatchdog(servers[1], interval=60.0))
    got, want = ours.tick(), theirs.tick()
    assert [_strip(a) for a in got] == [_strip(a) for a in want]
    assert {a["signal"] for a in got} == set(detectors.SIGNALS)
    reg = next(a for a in got if a["signal"] == "step_time_regression")
    assert reg["evidence"]["rank"] == "0" and reg["armed"]["id"] == "arm-1"
    assert ours.tick() == [] and ours.arms == 1  # the cooldown holds them
    assert [_strip(a) for a in servers[0].alerts_report()["alerts"]] == \
        [_strip(a) for a in servers[1].alerts_report()["alerts"]]
    rec = json.loads(servers[0].get(autoarm.ARM_SCOPE, autoarm.ARM_KEY))
    assert (rec["start_step"], rec["end_step"]) == \
        (reg["armed"]["start_step"], reg["armed"]["end_step"])


def test_alerts_on_a_host_up_for_less_than_the_cooldown(servers,
                                                      monkeypatch, tmp_path):
    """The cooldown counts from the last alert, not from the monotonic
    clock's zero: the reference stays silent while the host has been up
    for less than ``HVD_WATCH_ARM_COOLDOWN_SECONDS`` (120 s); the port
    alerts and arms."""
    monkeypatch.setenv("HVD_TIMELINE", str(tmp_path))
    steps = [(i + 1, 0.100 if i % 2 else 0.101) for i in range(48)] + \
        [(49 + i, 0.160) for i in range(8)]
    for server in servers:
        _push(server, 0, step_seconds=steps)
    ours, theirs = (Watchdog(servers[0], interval=60.0),
                    RefWatchdog(servers[1], interval=60.0))
    monkeypatch.setattr("time.monotonic", lambda: 30.0)  # 30 s after boot
    assert theirs.tick() == [] and theirs.arms == 0
    got = ours.tick()
    assert [a["signal"] for a in got] == ["step_time_regression"]
    assert got[0]["armed"]["id"] == "arm-1" and ours.arms == 1
    assert ours.tick() == []  # then the cooldown holds


def test_critical_straggler_is_evicted_only_under_watch_evict(
        servers, monkeypatch):
    class _Driver:
        world = ["w0", "w1", "w2", "w3"]

        def __init__(self):
            self.removed = []

        def remove(self, worker, reason, *, drain=False, cause_id=None):
            self.removed.append((worker, drain))
            return True

    server = servers[0]
    for rank in (0, 2, 3):
        _push(server, rank, step_seconds=[(i + 1, 0.1) for i in range(16)])
    _push(server, 1, step_seconds=[(i + 1, 0.2) for i in range(16)])
    drivers = []
    for evict in ("0", "1"):
        monkeypatch.setenv("HVD_WATCH_EVICT", evict)
        dog = Watchdog(server, driver=_Driver(), interval=60.0)
        (alert,) = dog.tick()
        assert alert["severity"] == "critical"
        drivers.append((dog._driver.removed, alert.get("evicted")))
    assert drivers == [([], None), ([("w1", True)], "w1")]


def test_start_from_env_is_on_by_default_and_joins(servers, monkeypatch):
    """On by default, off under ``HVD_WATCH=0``.  A stopped watchdog
    joins: the reference's keeps its stop event in ``self._stop``, which
    shadows ``threading.Thread._stop``, so its ``join()`` (and
    ``is_alive()`` once it ended) raise ``TypeError``."""
    monkeypatch.delenv("HVD_WATCH", raising=False)
    dog = watchdog_mod.start_from_env(servers[0])
    assert dog is not None and dog.is_alive()
    dog.stop()
    dog.join(timeout=10.0)
    assert not dog.is_alive()
    ref = RefWatchdog(servers[1], interval=0.01)
    ref.start()
    ref.stop()
    with pytest.raises(TypeError, match="not callable"):
        ref.join(timeout=10.0)
    monkeypatch.setenv("HVD_WATCH", "0")
    assert watchdog_mod.start_from_env(servers[0]) is None


# -- auto-arm and the dormant profiler ---------------------------------------
def test_arm_record_reaches_the_dormant_profiler(servers, monkeypatch,
                                                 tmp_path):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE", "HVD_PROFILE", "HVD_TIMELINE",
              "HVD_TRACE_DIR", "HVD_WATCH_ARM"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(timeseries, "store",
                        timeseries.TimeseriesStore(enabled=True))
    core.shutdown()
    core.init(device="cpu")
    try:
        model = MLP(4, (3,))
        make = lambda: training.make_train_step(  # noqa: E731
            apply_fn=model, loss_fn=F.cross_entropy,
            optimizer=fused_sgd(0.1))
        monkeypatch.setenv("HVD_WATCH_ARM", "0")
        assert make().profiler is None
        monkeypatch.delenv("HVD_WATCH_ARM")
        step = make()
        prof = step.profiler
        assert not prof.enabled and prof in autoarm._profilers
        state = training.init_train_state(model, fused_sgd(0.1))
        x, y = torch.ones(2, 4), torch.zeros(2, dtype=torch.long)
        for i in range(5):  # the rank is at step 5 by its cadence
            state, _ = step(state, x, y)
            timeseries.record(timeseries.STEP_SECONDS, 0.01, step=i + 1)
        server, port = servers[0], servers[0].port
        autoarm.broadcast_arm(server, "arm-1", 7, 8, "step_time_regression",
                              str(tmp_path))
        assert autoarm.poll_and_apply("127.0.0.1", port, secret=SECRET)
        assert prof.enabled and (prof.start_step, prof.end_step) == (7, 8)
        assert not autoarm.poll_and_apply("127.0.0.1", port, secret=SECRET)
        for _ in range(4):  # calls 6-9: 7 and 8 profiled, 9 finalizes
            state, loss = step(state, x, y)
        assert prof.anatomy["steps"] == 2
        assert (tmp_path / "0" / "compute.json").exists()
        assert state.step == 9 and np.isfinite(loss.item())
    finally:
        core.shutdown()


def test_a_released_step_leaves_the_arm_registry(monkeypatch):
    for k in ("HVD_PROFILE", "HVD_WATCH_ARM"):
        monkeypatch.delenv(k, raising=False)
    autoarm.reset()
    core.shutdown()
    core.init(device="cpu")
    try:
        step = training.make_train_step(
            apply_fn=MLP(4, (3,)), loss_fn=F.cross_entropy,
            optimizer=fused_sgd(0.1))
        assert list(autoarm._profilers) == [step.profiler]
        del step
        gc.collect()
        assert not list(autoarm._profilers)
    finally:
        autoarm.reset()
        core.shutdown()


def test_a_lone_spike_in_the_clean_cadence_is_an_early_fire(monkeypatch):
    """``scripts/torch_serve_tasks.py``'s ``early_fires``: on a cadence as
    tight as a graphed step's, one spike of a few ms (a poll of the
    launcher between two calls) fires the step-time detector on the tick
    that sees it first of its last three samples; spikes after the
    slowdown are not counted."""
    import importlib.util
    from pathlib import Path

    for k in [k for k in os.environ if k.startswith("HVD_WATCH")]:
        monkeypatch.delenv(k)
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_serve_tasks.py"
    spec = importlib.util.spec_from_file_location("torch_serve_tasks", path)
    tasks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tasks)

    rng = np.random.default_rng(15)
    cadence = [[st, 0.0365 + 4e-5 * float(rng.standard_normal())]
               for st in range(2, 61)]
    assert tasks.early_fires(cadence, 40) == []
    cadence[31 - 2][1] += 0.005                  # the sample after step 30
    cadence[51 - 2][1] += 0.005                  # after the slowdown
    fires = tasks.early_fires(cadence, 40)
    assert fires and fires[0] == 33 and max(fires) <= 40
    # what the launcher's own tick computes on the prefix ending at 33
    tail = [(st, v) for st, v in cadence if st <= 33]
    alert = detectors.ewma_mad_regression(tail, warmup=len(tail) - 3)
    assert alert["evidence"]["fired_step"] == 33
