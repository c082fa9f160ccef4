"""The port's launcher (``horovod_tpu_torch/run/{run,hosts,discovery,
config_parser,task_fn}.py``) held to the reference's, and driven on the
CPU.

* Where the semantics are the reference's, the results are: ``parse_args``
  (every flag, and a YAML ``--config-file`` that the command line
  overrides), ``parse_hosts`` / ``parse_hostfile`` / ``allocate_slots``,
  ``ssh_command``, ``discover_tpu_hosts`` from ``HVD_TPU_HOSTS`` and
  ``config_parser.env_from_args``.
* ``worker_envs`` is held to its documented difference: one process per
  slot (the reference: one per host), each with its slot's rank, local
  and cross ranks from the same slot table, the world size and, for more
  than one process, the launcher's store (``HVD_COORDINATOR_ADDR`` with
  ``HVD_COORDINATOR_SERVER=external``).
* ``--serve``, its knobs and ``HVD_WATCH`` (refused until the serving
  plane and the watchdog were ported) plan their workers and map to the
  reference's environment; ``--elastic`` /
  ``--min-np`` and ``--controller native`` (or ``auto`` over several
  hosts) plan their workers' environment; ``--dry-run`` prints the plan; ``--check-build``
  reports the port's stack; a missing ``yaml`` and a function the
  standard ``pickle`` cannot carry give errors that say so.
* ``python -m horovod_tpu_torch.run -np 2 ...`` trains the MLP on gloo
  (``torch_launch_tasks.py`` ``train``): the ranks end with equal
  parameters, and the launcher's server holds both ranks' snapshots
  under keys ``0`` and ``1`` and both leases; ``run(fn, np=2)`` returns
  both ranks' results; ``--restarts`` relaunches a failed attempt.
"""

import dataclasses
import importlib
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu.run import config_parser as ref_config
from horovod_tpu.run import discovery as ref_discovery
from horovod_tpu.run import hosts as ref_hosts
from horovod_tpu_torch.run import config_parser, discovery, hosts

# the packages export the function ``run`` over the module of that name
ref_run = importlib.import_module("horovod_tpu.run.run")
port_run = importlib.import_module("horovod_tpu_torch.run.run")

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
TASKS = TESTS / "torch_launch_tasks.py"

ARGVS = [
    ["-np", "4", "python", "train.py"],
    ["-np", "8", "-H", "a:4,b:4", "--fusion-threshold-mb", "32",
     "--cycle-time-ms", "3.5", "--hierarchical-allreduce", "--compression",
     "int8", "--no-error-feedback", "--autotune", "--autotune-log-file",
     "at.csv", "--autotune-warmup-samples", "2", "--timeline-filename",
     "/tmp/tl", "--trace-start-step", "3", "--trace-end-step", "5",
     "--no-stall-check", "--stall-check-warning-time-seconds", "9",
     "--log-level", "debug", "--restarts", "2", "--relay", "--journal",
     "/tmp/j", "--output-filename", "out", "--", "python", "-c", "pass"],
    ["--hostfile", "hf", "--ssh-port", "2222", "--start-timeout", "30",
     "--two-level-allreduce", "--profile-guided", "--autotune-window-steps",
     "7", "--dry-run", "--controller", "xla", "python", "x.py", "--lr", "1"],
]


def _vars(args) -> dict:
    return {k: v for k, v in vars(args).items()}


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_is_the_references(argv):
    assert _vars(port_run.parse_args(argv)) == _vars(ref_run.parse_args(argv))


def test_config_file_is_the_references(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("params:\n  fusion_threshold_mb: 16\n  compression: bf16\n"
                   "autotune:\n  enabled: true\n  warmup_samples: 4\n"
                   "timeline:\n  filename: /tmp/t\n"
                   "stall_check:\n  warning_time_seconds: 12\n"
                   "control_plane:\n  relay: true\n"
                   "logging:\n  level: info\n")
    argv = ["-np", "2", "--config-file", str(cfg), "--compression", "int8",
            "python", "t.py"]
    got = port_run.parse_args(argv)
    assert _vars(got) == _vars(ref_run.parse_args(argv))
    assert (got.fusion_threshold_mb, got.compression) == (16, "int8")
    assert config_parser.env_from_args(got) == \
        ref_config.env_from_args(ref_run.parse_args(argv))


def test_config_file_without_yaml_says_so(tmp_path, monkeypatch):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("params: {}\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="yaml"):
        port_run.parse_args(["--config-file", str(cfg), "python", "x"])


@pytest.mark.parametrize("argv", ARGVS)
def test_env_from_args_is_the_references(argv):
    assert config_parser.env_from_args(port_run.parse_args(argv)) == \
        ref_config.env_from_args(ref_run.parse_args(argv))


def _asdicts(items) -> list:
    return [dataclasses.asdict(i) for i in items]


@pytest.mark.parametrize("spec,np_", [("localhost:4", 4), ("a:2,b:2", 4),
                                      ("a:3,b:1,c:2", 5), ("h1", 1)])
def test_hosts_and_slots_are_the_references(spec, np_):
    got, want = hosts.parse_hosts(spec), ref_hosts.parse_hosts(spec)
    assert _asdicts(got) == _asdicts(want)
    assert _asdicts(hosts.allocate_slots(got, np_)) == \
        _asdicts(ref_hosts.allocate_slots(want, np_))


def test_hostfile_is_the_references(tmp_path):
    hf = tmp_path / "hostfile"
    hf.write_text("# cluster\nnode1 slots=4\nnode2 slots=2\n\nnode3\n")
    assert _asdicts(hosts.parse_hostfile(str(hf))) == \
        _asdicts(ref_hosts.parse_hostfile(str(hf)))


def test_ssh_command_is_the_references():
    env = {"HVD_RANK": "3", "HVD_METRICS_SECRET": "ab cd", "A": "x'y"}
    cmd = ["python", "train.py", "--name", "a b"]
    for kw in ({}, {"ssh_port": 2222, "cwd": "/work dir"}):
        assert port_run.ssh_command("node2", env, cmd, **kw) == \
            ref_run.ssh_command("node2", env, cmd, **kw)


def test_discovery_from_env_is_the_references(monkeypatch):
    monkeypatch.setenv("HVD_TPU_HOSTS", "t1:4,t2:4")
    assert _asdicts(discovery.discover_tpu_hosts()) == \
        _asdicts(ref_discovery.discover_tpu_hosts())
    args = port_run.parse_args(["--tpu", "python", "x"])
    assert _asdicts(port_run._resolve_hosts(args)) == \
        _asdicts(ref_run._resolve_hosts(ref_run.parse_args(
            ["--tpu", "python", "x"])))


@pytest.mark.parametrize("spec,np_", [("localhost:4", 4), ("a:2,b:2", 4)])
def test_worker_envs_one_process_a_slot(spec, np_):
    slots = hosts.allocate_slots(hosts.parse_hosts(spec), np_)
    ref_slots = ref_hosts.allocate_slots(ref_hosts.parse_hosts(spec), np_)
    envs = port_run.worker_envs(slots, {"X": "1"}, "h:7", controller="xla")
    # the reference: one process a host, owning the host's slots
    assert len(ref_run.worker_envs(ref_slots, {}, "h:7",
                                   controller="xla")) == len(
        {s.hostname for s in slots})
    assert len(envs) == np_
    for env, s in zip(envs, ref_slots):
        assert env["X"] == "1"
        assert (env["HVD_PROCESS_ID"], env["HVD_RANK"]) == (str(s.rank),) * 2
        assert (env["HVD_NUM_PROCESSES"], env["HVD_SIZE"]) == (str(np_),) * 2
        assert env["HVD_LOCAL_RANK"] == str(s.local_rank)
        assert env["HVD_LOCAL_SIZE"] == str(s.local_size)
        assert env["HVD_CROSS_RANK"] == str(s.cross_rank)
        assert env["HVD_CROSS_SIZE"] == str(s.cross_size)
        assert env["HVD_COORDINATOR_ADDR"] == "h:7"
        assert env["HVD_COORDINATOR_SERVER"] == "external"
    one = port_run.worker_envs(slots[:1], {}, "", controller="xla")
    assert "HVD_COORDINATOR_ADDR" not in one[0]


@pytest.mark.parametrize("argv,env,want", [
    (["--serve"], {}, {"HVD_SERVE": "1"}),
    (["--serve-max-batch", "4"], {}, {"HVD_SERVE_MAX_BATCH": "4"}),
    ([], {"HVD_SERVE": "1"}, {}),
    ([], {"HVD_WATCH": "1"}, {}),
])
def test_serve_and_watch_options_plan_their_workers(monkeypatch, capsys,
                                                    argv, env, want):
    """The serving options and ``HVD_WATCH``, which the launcher refused
    before the serving plane and the watchdog were ported: the dry run
    plans the workers, and the flags map to the reference's
    environment."""
    monkeypatch.delenv("HVD_METRICS_KV_ADDR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_run.run_commandline(["-np", "2", *argv, "--dry-run",
                                     "python", "-c", "pass"]) == 0
    assert "[dry-run] process 1" in capsys.readouterr().out
    argv = ["-np", "2", *argv, "python", "-c", "pass"]
    got = config_parser.env_from_args(port_run.parse_args(argv))
    assert got == ref_config.env_from_args(ref_run.parse_args(argv))
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("argv,want", [
    (["--elastic"], {"HVD_ELASTIC": "1", "HVD_ELASTIC_WORKER_ID": "1",
                     "HVD_CONTROLLER": "xla"}),
    (["--elastic", "--min-np", "1"], {"HVD_ELASTIC": "1"}),
    (["--controller", "native"], {
        "HVD_CONTROLLER": "native",
        "HVD_CONTROLLER_ADDR": "<launcher>:<bound-at-launch>",
        "HVD_CONTROLLER_SERVER": "external", "HVD_RING_HOST": "localhost"}),
    (["-H", "a:1,b:1"], {"HVD_CONTROLLER": "native",
                         "HVD_RING_HOST": "b"}),
])
def test_elastic_and_native_options_plan_their_workers(monkeypatch, capsys,
                                                       argv, want):
    """The options of the elastic driver and the native controller, which
    the launcher refused before they were ported: the dry run prints
    each worker's plan with their environment (worker 1 shown)."""
    monkeypatch.delenv("HVD_METRICS_KV_ADDR", raising=False)
    assert port_run.run_commandline(["-np", "2", *argv, "--dry-run",
                                     "python", "-c", "pass"]) == 0
    out = capsys.readouterr().out
    worker1 = out[out.index("[dry-run] process 1"):]
    for k, v in want.items():
        assert f"  {k}={v}\n" in worker1, (k, worker1)


def test_dry_run_prints_the_plan(capsys, monkeypatch):
    monkeypatch.delenv("HVD_METRICS_KV_ADDR", raising=False)
    assert port_run.run_commandline(["-np", "2", "--dry-run", "python", "-c",
                                     "pass"]) == 0
    out = capsys.readouterr().out
    for pid in (0, 1):
        assert f"[dry-run] process {pid} on localhost:" in out
        assert f"HVD_PROCESS_ID={pid}" in out
    assert out.count("HVD_COORDINATOR_ADDR=<launcher>:<bound-at-launch>") == 2
    assert "command: python -c pass" in out


def test_check_build_reports_the_ports_stack(capsys):
    assert port_run.run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("horovod_tpu_torch v")
    for what in ("PyTorch", "torch.distributed", "gloo", "nvcc",
                 "libhvd_torch_kernels.so", "native core"):
        assert what in out


def test_function_mode_pickles_without_cloudpickle(monkeypatch):
    from torch_launch_tasks import allreduce_rank

    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    blob = port_run._dumps_fn((allreduce_rank, (), {}))
    assert pickle.loads(blob)[0] is allreduce_rank
    with pytest.raises(TypeError, match="cloudpickle is not installed"):
        port_run._dumps_fn((lambda: 1, (), {}))


def _launch_env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    env.update({"PYTHONPATH": os.pathsep.join([str(REPO), str(TESTS)]),
                "OMP_NUM_THREADS": "1", "HVD_HEARTBEAT_INTERVAL_SECONDS":
                "0.5"})
    return env


def test_launcher_trains_the_mlp_on_two_ranks(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         sys.executable, str(TASKS), "train", str(tmp_path)],
        cwd=REPO, env=_launch_env(), capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ranks = [json.loads((tmp_path / f"train.{r}.json").read_text())
             for r in (0, 1)]
    for r in ranks:
        assert (r["size"], r["device"]) == (2, "cpu")
        assert np.isfinite(r["losses"]).all()
    for k in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[0]["params"][k],
                                      ranks[1]["params"][k])
    server = json.loads((tmp_path / "train.server.json").read_text())
    # one snapshot a rank, keyed by the pushing process's own rank
    assert sorted(server["metrics"]) == ["0", "1"]
    for snap in server["metrics"].values():
        assert snap["metrics"]["hvd_steps_total"]["samples"][0]["value"] == 3
    for rank in ("0", "1"):
        assert f'hvd_steps_total{{rank="{rank}"}} 3' in server["prometheus"]
    assert sorted(server["health"]["ranks"]) == ["0", "1"]
    assert server["health"]["abort"] is None
    assert "[0]<stdout>" in proc.stdout and "[1]<stdout>" in proc.stdout


def test_restarts_relaunch_after_a_failure(tmp_path):
    """``--restarts 1``: the first attempt exits 3, the launcher relaunches
    with ``HVD_RESTART_COUNT=1``, which succeeds; each attempt's output
    has its own file."""
    env = _launch_env()
    env["HVD_RESTART_BACKOFF_SECONDS"] = "0.01"
    out = tmp_path / "out"
    worker = ("import os, sys; print('attempt', os.environ['HVD_RESTART_"
              "COUNT']); sys.exit(0 if os.environ['HVD_RESTART_COUNT'] == "
              "'1' else 3)")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
         "--restarts", "1", "--output-filename", str(out), sys.executable,
         "-c", worker], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (out / "rank.0.txt").read_text() == "attempt 0\n"
    assert (out / "rank.0.restart1.txt").read_text() == "attempt 1\n"


def test_function_mode_on_two_ranks(monkeypatch):
    from torch_launch_tasks import allreduce_rank

    from horovod_tpu_torch.observe import events

    for k in [k for k in os.environ if k.startswith("HVD_")]:
        monkeypatch.delenv(k)
    try:
        results = port_run.run(allreduce_rank, np=2, extra_env={
            "PYTHONPATH": os.pathsep.join([str(REPO), str(TESTS)]),
            "OMP_NUM_THREADS": "1"})
    finally:
        events._reset_for_tests()  # run() attached the recorder to its server
    assert results == [(0, 2, [3.0, 3.0]), (1, 2, [3.0, 3.0])]
