"""horovod_tpu_torch.elastic.{membership,driver} against the reference's.

* a scripted run of the elastic driver — rank 1's worker dies, rejoins
  at a stable epoch, dies again and, at ``HVD_ELASTIC_MAX_FLAPS`` (2), is
  blocklisted and its next announcement dropped — commits the same
  epoch records and blocklists as the reference's driver, apart from
  addresses, times and event ids;
* the worker side in one process: ``attach`` adopts and acks the
  committed epoch (rank, world, the epoch's store), ``apply_epoch``
  rebuilds into it, an evicted worker gets ``RemovedFromWorldError``,
  and the split-brain fence refuses a stale epoch, as the reference's;
* one drive through the launcher (``--elastic``, 3 gloo processes on the
  CPU, ``tests/torch_launch_tasks.py elastic``): worker 2 dies at its
  fourth step; the survivors rebuild into a world of 2 (a fresh store),
  re-sync the state from rank 0 and train on.  Their losses continue the
  trajectory a single process computes over the same global batches
  (3 shards, then 2), to 1e-5.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu.elastic import driver as ref_driver
from horovod_tpu.run import http_server as ref_http_server
from horovod_tpu_torch.elastic import driver, membership
from horovod_tpu_torch.elastic.abort import HorovodAbortError
from horovod_tpu_torch.run import http_server

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
VOLATILE = ("time", "event_id", "correlation_id", "controller_addr",
            "coordinator_addr")


def _records(drv_mod, srv_mod, monkeypatch) -> list:
    monkeypatch.setenv("HVD_ELASTIC_MAX_FLAPS", "2")
    server = srv_mod.RendezvousServer()
    server.start()
    out = []

    def snap(what):
        rec = json.loads(server.get("membership", "epoch"))
        out.append((what, {k: v for k, v in rec.items()
                           if k not in VOLATILE},
                    json.loads(server.get("membership", "blocklist")),
                    server.get("abort", "flag") is not None))

    def ack_all(drv):
        for w in drv.world:
            server.put("membership", f"ready.{drv.epoch}.{w}", b"{}")

    def announce(w):
        server.put("membership", f"announce.{w}", json.dumps(
            {"worker": w}).encode())

    try:
        drv = drv_mod.ElasticDriver(server, ["0", "1", "2"], min_np=1,
                                    controller="xla")
        snap("initial")
        assert drv.remove("1", "worker 1 exited with code 17")
        snap("death")
        ack_all(drv)
        announce("1")
        drv.poll()  # stable: the abort scope clears, then the admission
        snap("rejoin")
        ack_all(drv)
        drv.poll()
        snap("stable")
        assert drv.remove("1", "worker 1 exited with code 17 again")
        snap("flap")
        ack_all(drv)
        announce("1")
        drv.poll()
        snap("blocklisted")
        out.append(("left", drv.epoch, list(drv.world),
                    sorted(drv.blocklist), dict(drv.flaps),
                    sorted(k for k in server.scope_items("membership")
                           if k.startswith("announce."))))
        drv.shutdown()
    finally:
        server.stop()
    return out


def test_scripted_epochs_equal_reference_driver(monkeypatch):
    want = _records(ref_driver, ref_http_server, monkeypatch)
    got = _records(driver, http_server, monkeypatch)
    assert got == want
    worlds = [r[1]["world"] for r in got[:-1]]
    assert worlds == [["0", "1", "2"], ["0", "2"], ["0", "2", "1"],
                      ["0", "2", "1"], ["0", "2"], ["0", "2"]]
    assert got[-1][:4] == ("left", 3, ["0", "2"], ["1"])


def test_driver_makes_a_store_each_epoch(monkeypatch):
    server = http_server.RendezvousServer()
    server.start()
    made = []

    class Store:
        def __init__(self, n):
            self.port = 1000 + len(made)
            made.append(n)

    try:
        drv = driver.ElasticDriver(server, ["0", "1", "2"],
                                   store_factory=Store)
        assert drv.remove("2", "died")
        rec = json.loads(server.get("membership", "epoch"))
        assert made == [3, 2] and len(drv.stores) == 2
        assert rec["coordinator_addr"] == "127.0.0.1:1001"
    finally:
        server.stop()


@pytest.fixture()
def wired(monkeypatch):
    server = http_server.RendezvousServer(secret=b"m")
    port = server.start()
    for k, v in {"HVD_METRICS_KV_ADDR": "127.0.0.1",
                 "HVD_METRICS_KV_PORT": str(port),
                 "HVD_METRICS_SECRET": b"m".hex(), "HVD_ELASTIC": "1",
                 "HVD_ELASTIC_WORKER_ID": "2", "HVD_PROCESS_ID": "2",
                 "HVD_NUM_PROCESSES": "3", "HVD_LOCAL_SIZE": "3",
                 "HVD_HEARTBEAT_DISABLE": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HVD_COORDINATOR_ADDR", raising=False)
    membership._reset_for_tests()
    saved = dict(os.environ)  # attach / apply_epoch rewrite the identity
    yield server
    os.environ.clear()
    os.environ.update(saved)
    membership._reset_for_tests()
    server.stop()


def test_worker_side_adopts_acks_fences_and_evicts(wired, monkeypatch):
    server = wired
    drv = driver.ElasticDriver(server, ["0", "1", "2"])
    assert drv.remove("1", "died")
    server.put("membership", "epoch", json.dumps(dict(
        json.loads(server.get("membership", "epoch")),
        coordinator_addr="127.0.0.1:4321")).encode())
    rec = membership.attach()
    assert rec["epoch"] == 1 and membership.current_epoch() == 1
    assert os.environ["HVD_PROCESS_ID"] == "1"
    assert os.environ["HVD_NUM_PROCESSES"] == "2"
    assert os.environ["HVD_COORDINATOR_ADDR"] == "127.0.0.1:4321"
    assert "HVD_LOCAL_SIZE" not in os.environ
    assert server.get("membership", "ready.1.2") is not None
    membership.check_fence()
    drv.remove("0", "died")
    with pytest.raises(HorovodAbortError, match="fencing"):
        membership.check_fence()
    with pytest.raises(membership.RemovedFromWorldError):
        membership.apply_epoch({"epoch": 3, "world": ["0"]})


def _expected_losses(steps_3: int, steps_2: int) -> list:
    """The task's MLP on one process over the global batch: the 3 ranks'
    shards for ``steps_3`` steps, then ranks 0 and 1's."""
    sys.path.insert(0, str(TESTS))
    import torch_launch_tasks as tasks

    from horovod_tpu_torch import core

    core.shutdown()
    core.init(device="cpu")
    try:
        step, state = tasks._mlp_step()
        out = []
        for n, steps in ((3, steps_3), (2, steps_2)):
            shards = [tasks._shard(r) for r in range(n)]
            x = torch.cat([s[0] for s in shards])
            y = torch.cat([s[1] for s in shards])
            for _ in range(steps):
                state, loss = step(state, x, y)
                out.append(loss.item())
        return out
    finally:
        core.shutdown()


def test_three_to_two_elastic_drive_continues_its_losses(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    env.update({"PYTHONPATH": os.pathsep.join([str(REPO), str(TESTS)]),
                "OMP_NUM_THREADS": "1",
                # a lease is dead after 4 intervals: a survivor starved of
                # CPU for 1 s under a loaded run must not read as one
                "HVD_HEARTBEAT_INTERVAL_SECONDS": "1.0",
                "HVD_FAULT_SPEC": "rank=2:step=3:kind=crash"})
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "3",
         "--elastic", sys.executable, str(TESTS / "torch_launch_tasks.py"),
         "elastic", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    logs = {w: json.loads((tmp_path / f"elastic.{w}.json").read_text())
            for w in ("0", "1", "2")}
    assert [s for s, *_ in logs["2"]] == [1, 2, 3]  # died at its 4th step
    assert logs["0"] == logs["1"]
    steps = [s for s, *_ in logs["0"]]
    assert steps == list(range(1, 9))  # no step lost or repeated
    sizes = [(size, epoch) for _, _, size, epoch in logs["0"]]
    assert sizes == [(3, 0)] * 3 + [(2, 1)] * 5
    np.testing.assert_allclose([loss for _, loss, *_ in logs["0"]],
                               _expected_losses(3, 5), rtol=1e-5)
