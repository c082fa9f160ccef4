"""The port's failure-domain runtime (``horovod_tpu_torch/elastic/
{abort,heartbeat}.py``) held to the reference's, against either
package's rendezvous server, and the launcher's fail-fast path on gloo.

* ``make_flag`` / ``format_abort`` give the reference's flags and
  messages; ``publish`` / ``trigger`` / ``read_flag`` / ``abort`` round
  trip the flag through the server, the reference's reader included.
* A heartbeat renews its lease under ``/health/<rank>`` with the
  reference's fields (``GET /health`` reports it live), learns the abort
  verdict from the renewal's reply, and then the train step and the
  eager dispatch raise ``HorovodAbortError`` before any collective.
* ``start_from_env`` starts nothing for one process and raises for an
  elastic job (ROADMAP item 13).
* ``python -m horovod_tpu_torch.run -np 2`` with a rank that exits 1:
  the launcher publishes the abort flag, the survivor raises
  ``HorovodAbortError`` naming the failed worker within 2 × the
  heartbeat interval + the term grace, and the job's exit code is 1.
"""

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as htt
from horovod_tpu_torch import core, eager, training
from horovod_tpu_torch.elastic import heartbeat
from horovod_tpu_torch.elastic.abort import (
    HorovodAbortError, format_abort, make_flag, publish, read_flag, trigger,
)
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.optim.fused_update import fused_sgd
from torch_rdv import SECRET, kv_env, serving

ref_abort = importlib.import_module("horovod_tpu.elastic.abort")
ref_heartbeat = importlib.import_module("horovod_tpu.elastic.heartbeat")

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
HB_S, GRACE_S = 0.25, 3.0


@pytest.fixture(autouse=True)
def _no_heartbeat():
    """No heartbeat, and no flight-recorder flusher (publishing a flag
    records an event) outlives a test."""
    from horovod_tpu_torch.observe import events

    heartbeat.stop()
    yield
    heartbeat.stop()
    events._reset_for_tests()


@pytest.mark.parametrize("kw", [{}, {"rank": 3}, {"rank": 1, "epoch": 2},
                                {"source": "launcher", "rank": 0}])
def test_flags_and_messages_are_the_references(monkeypatch, kw):
    monkeypatch.setenv("HVD_PROCESS_ID", "5")
    got, want = make_flag("worker died", **kw), \
        ref_abort.make_flag("worker died", **kw)
    for f in (got, want):
        f.pop("time")
    assert got == want
    assert format_abort(got) == ref_abort.format_abort(want)


@pytest.mark.parametrize("server", ["port", "reference"])
def test_the_flag_round_trips(monkeypatch, server):
    with serving(server) as srv:
        assert publish(make_flag("x", rank=1, source="launcher"),
                       addr="127.0.0.1", port=srv.port, secret=SECRET)
        flag = read_flag("127.0.0.1", srv.port, secret=SECRET)
        assert flag == ref_abort.read_flag("127.0.0.1", srv.port,
                                           secret=SECRET)
        assert (flag["reason"], flag["rank"], flag["source"]) == \
            ("x", 1, "launcher")
        assert srv.health_report()["abort"]["reason"] == "x"
        kv_env(monkeypatch, srv)
        assert trigger("stalled", source="stall_inspector")
        with pytest.raises(htt.HorovodAbortError, match="user gave up"):
            htt.abort("user gave up")
        assert read_flag("127.0.0.1", srv.port,
                         secret=SECRET)["reason"] == "user gave up"


@pytest.mark.parametrize("server", ["port", "reference"])
def test_the_lease_and_the_abort_verdict(server):
    with serving(server) as srv:
        hbs = [mod.HeartbeatThread(r, 4, "127.0.0.1", srv.port,
                                   secret=SECRET, interval=60.0)
               for mod, r in ((heartbeat, 2), (ref_heartbeat, 3))]
        for hb in hbs:
            hb.beat()
        report = srv.health_report()
        got, want = report["ranks"]["2"], report["ranks"]["3"]
        assert got.pop("verdict") == want.pop("verdict") == "live"
        assert sorted(got) == sorted(want)
        assert (got["count"], got["interval"], got["pid"]) == \
            (0, 60.0, os.getpid())
        assert all(hb.abort_info is None for hb in hbs)
        srv.put("abort", "flag", json.dumps(
            make_flag("worker 1 exited with code 1", rank=1,
                      source="launcher")).encode())
        for hb in hbs:
            hb.beat()
        assert hbs[0].abort_info == hbs[1].abort_info
        assert hbs[0].abort_info["reason"] == "worker 1 exited with code 1"


def test_the_step_and_the_dispatch_raise_at_the_seam(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    try:
        model = MLP(4, (5, 3))
        opt = fused_sgd(0.1)
        step = training.make_train_step(apply_fn=model,
                                        loss_fn=F.cross_entropy,
                                        optimizer=opt, loss_fetch_steps=0)
        state = training.init_train_state(model, opt)
        x, y = torch.ones(2, 4), torch.zeros(2, dtype=torch.long)
        state, _ = step(state, x, y)
        with serving("port") as srv:
            srv.put("abort", "flag", json.dumps(
                make_flag("peer lost", rank=1, source="launcher")).encode())
            heartbeat.start(0, 2, "127.0.0.1", srv.port, secret=SECRET,
                            interval=60.0)
            deadline = time.monotonic() + 10
            while heartbeat.instance().abort_info is None:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        calls = dict(step.calls)
        with pytest.raises(HorovodAbortError, match="peer lost"):
            step(state, x, y)
        assert dict(step.calls) == calls     # no step was dispatched
        with pytest.raises(HorovodAbortError, match="peer lost"):
            with eager._host_guard("t", "MESH_ALLREDUCE", "allreduce",
                                   "mesh", 4):
                pytest.fail("entered the collective")
    finally:
        heartbeat.stop()
        core.shutdown()


def test_start_from_env(monkeypatch):
    with serving("port") as srv:
        kv_env(monkeypatch, srv)
        monkeypatch.setenv("HVD_NUM_PROCESSES", "1")
        assert heartbeat.start_from_env() is None
        monkeypatch.setenv("HVD_NUM_PROCESSES", "2")
        monkeypatch.setenv("HVD_PROCESS_ID", "1")
        monkeypatch.setenv("HVD_HEARTBEAT_INTERVAL_SECONDS", "60")
        hb = heartbeat.start_from_env()
        assert hb is heartbeat.instance() and hb.rank == 1
        heartbeat.stop()
        monkeypatch.setenv("HVD_HEARTBEAT_DISABLE", "1")
        assert heartbeat.start_from_env() is None
        monkeypatch.delenv("HVD_HEARTBEAT_DISABLE")
        monkeypatch.setenv("HVD_ELASTIC", "1")
        with pytest.raises(NotImplementedError, match="item 13"):
            heartbeat.start_from_env()


def test_a_failing_rank_ends_the_job(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    env.update({"PYTHONPATH": os.pathsep.join([str(REPO), str(TESTS)]),
                "OMP_NUM_THREADS": "1",
                "HVD_HEARTBEAT_INTERVAL_SECONDS": str(HB_S),
                "HVD_TERM_GRACE_SECONDS": str(GRACE_S)})
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--output-filename", str(out), sys.executable,
         str(TESTS / "torch_launch_tasks.py"), "fail", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    left = json.loads((tmp_path / "fail.1.json").read_text())
    seen = json.loads((tmp_path / "fail.0.json").read_text())
    assert "worker 1 exited with code 1" in seen["error"]
    assert "reported by launcher" in seen["error"]
    assert 0 < seen["aborted_at"] - left["exited_at"] < 2 * HB_S + GRACE_S
    assert "HorovodAbortError" in (out / "rank.0.txt").read_text()
    assert np.isfinite(seen["aborted_at"])
