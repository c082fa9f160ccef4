"""The port's stall inspector (``horovod_tpu_torch/runtime/
stall_inspector.py``) held to the reference's.

* The same operations, begun and inspected on both, give the same
  warnings, the same ``hvd_stall_warnings_total`` count and the same
  ``hvd_inflight_ops`` / ``hvd_stalled_ops`` gauges (registered
  instruments of each package's registry); past the shutdown threshold
  both call their shutdown callback with the operation's name.
* The default shutdown publishes the coordinated-abort flag on the
  rendezvous server (source ``stall_inspector``), then exits.
* The launcher's ``--no-stall-check`` and ``--stall-check-*-seconds``
  reach a worker's inspector through the environment.
* The eager plane's host guard keeps its collective in flight in the
  process's inspector while it runs, and ``core.init`` / ``shutdown``
  start and stop the inspector's thread.
"""

import importlib
import json

import pytest

from horovod_tpu_torch import core, eager
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch.runtime import stall_inspector as port
from horovod_tpu_torch.run import config_parser
from torch_rdv import kv_env, serving

ref = importlib.import_module("horovod_tpu.runtime.stall_inspector")
ref_metrics = importlib.import_module("horovod_tpu.metrics")
port_run = importlib.import_module("horovod_tpu_torch.run.run")


def _sample(registry, name):
    return registry.snapshot()["metrics"][name]["samples"][0]["value"]


def test_warnings_and_gauges_are_the_references():
    dead = {}
    got = port.StallInspector(warning_seconds=0.0, shutdown_seconds=0.0,
                              enabled=True)
    want = ref.StallInspector(warning_seconds=0.0, shutdown_seconds=0.0,
                              enabled=True)
    before = (port_metrics.STALL_WARNINGS.get(),
              ref_metrics.STALL_WARNINGS.get())
    try:
        for ins in (got, want):
            ins.register_metrics()
            ins.begin("allreduce.grad0")
            ins.begin("allgather.x")
            ins.end("allgather.x")
            ins.begin("broadcast.y")
            ins.check_once()
            ins.check_once()                  # each op warns once
        assert [w[0] for w in got.warnings] == \
            [w[0] for w in want.warnings] == ["allreduce.grad0", "broadcast.y"]
        assert port_metrics.STALL_WARNINGS.get() - before[0] == \
            ref_metrics.STALL_WARNINGS.get() - before[1] == 2
        for reg in (port_metrics.registry, ref_metrics.registry):
            assert _sample(reg, "hvd_inflight_ops") == 2
            assert _sample(reg, "hvd_stalled_ops") == 2
    finally:
        # the registries' gauges read the process-wide inspectors again
        port.inspector.register_metrics()
        ref.inspector.register_metrics()
    # past the shutdown threshold, the callback gets the op's name
    for name, ins in (("port", port), ("reference", ref)):
        s = ins.StallInspector(warning_seconds=0.0, shutdown_seconds=1e-9,
                               enabled=True,
                               on_shutdown=lambda op, n=name:
                               dead.setdefault(n, op))
        s.begin("allreduce.stuck")
        s.check_once()
    assert dead == {"port": "allreduce.stuck",
                    "reference": "allreduce.stuck"}


@pytest.mark.parametrize("server", ["port", "reference"])
def test_the_default_shutdown_publishes_the_abort_flag(monkeypatch, server):
    from horovod_tpu_torch.observe import events

    exits = []
    monkeypatch.setattr(port.os, "_exit", exits.append)
    try:
        with serving(server) as srv:
            kv_env(monkeypatch, srv)
            s = port.StallInspector(warning_seconds=0.0,
                                    shutdown_seconds=1e-9, enabled=True)
            s.begin("allreduce.stuck")
            s.check_once()
            flag = json.loads(srv.get("abort", "flag"))
    finally:
        events._reset_for_tests()
    assert exits == [1]
    assert flag["source"] == "stall_inspector"
    assert "allreduce.stuck" in flag["reason"]


def test_the_launchers_stall_flags_reach_the_inspector(monkeypatch):
    env = config_parser.env_from_args(port_run.parse_args(
        ["--stall-check-warning-time-seconds", "7",
         "--stall-check-shutdown-time-seconds", "30", "python", "x"]))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    s = port.StallInspector()
    assert (s.enabled, s.warning_seconds, s.shutdown_seconds) == \
        (True, 7.0, 30.0)
    env = config_parser.env_from_args(port_run.parse_args(
        ["--no-stall-check", "python", "x"]))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert not port.StallInspector().enabled


def test_the_host_guard_is_watched_and_init_starts_the_thread(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_STALL_CHECK_DISABLE"):
        monkeypatch.delenv(k, raising=False)
    seen = []
    with eager._host_guard("allreduce.w", "MESH_ALLREDUCE", "allreduce",
                           "mesh", 8):
        seen = list(port.inspector._entries)
    assert seen == ["allreduce.w"] and not port.inspector._entries
    core.shutdown()
    core.init(device="cpu")
    try:
        assert port.inspector._thread is not None
        assert port.inspector._thread.is_alive()
    finally:
        core.shutdown()
    assert port.inspector._thread is None
