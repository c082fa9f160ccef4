"""``python -m horovod_tpu_torch.run`` — the port's launcher CLI, and
function mode.

The port of ``horovod_tpu/run/run.py`` (``bin/tpurun``), itself a
re-design of ``horovodrun`` (reference horovod/run/run.py:395-615 arg
groups, :696-740 host parsing, :839-861 _launch_job; gloo_run's per-slot
env + ssh fan-out + output capture + failure kill at
run/gloo_run.py:142-288).  ``parse_args`` keeps every flag name of the
reference.  What the port does differently (ROADMAP "Decisions"):

* **one worker process per card (slot)**, not one per host: a port rank
  is a process driving one card (``core.py``), so :func:`worker_envs`
  gives every slot its own process with ``HVD_PROCESS_ID`` = its rank,
  ``HVD_NUM_PROCESSES`` = the world and the slot table's local and
  cross ranks and sizes;
* **the launcher holds the job's store**: for a world of more than one
  process the launcher binds a ``torch.distributed.TCPStore`` on port 0
  itself, exports its ``host:port`` as ``HVD_COORDINATOR_ADDR`` with
  ``HVD_COORDINATOR_SERVER=external``, and every rank joins it as a
  client (``core._rendezvous``).  No port is chosen, freed and bound
  later by another process, so two jobs on one host cannot meet at one
  port; a restart attempt gets a store of its own;
* rendezvous, metrics, leases and the abort flag ride the launcher's
  HTTP KV server (run/http_server.py), as in the reference;
* remote execution via ssh command lines (generated identically for
  string-assertion tests, reference test/test_run.py:259-362);
* local hosts ("localhost"/"127.0.0.1") spawn subprocesses directly;
* any worker exiting non-zero ends the whole job: the launcher publishes
  the coordinated-abort flag, the survivors' heartbeats raise
  ``HorovodAbortError`` at their next step or dispatch, and whatever is
  left is killed (reference gloo_run.py:253-259); SIGINT/SIGTERM
  propagate.

What the launcher cannot do yet raises ``NotImplementedError`` naming
its ROADMAP item: ``--elastic`` / ``--min-np`` (item 13), ``--serve`` and
the ``--serve-*`` knobs (item 14), ``--controller native`` and ``auto``
on a job that spans hosts (item 17b), and an explicit true
``HVD_WATCH`` (the watchdog, item 15; the reference starts it by
default, the port does not start it at all).

Also provides the in-process API ``horovod_tpu_torch.run.run(fn, ...)``
(reference run/run.py:870-956 func mode: the pickled fn is shipped
through the KV store and the results collected back).  The standard
``pickle`` carries an importable function; ``cloudpickle``, where it is
installed, carries a lambda or closure too.  For more than one process
the eager transport is the port's ``torch.distributed`` group on the
launcher's store.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import random
import secrets as _secrets
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..utils import env as env_util
from ..utils.logging import get_logger
from . import config_parser
from .hosts import HostInfo, SlotInfo, allocate_slots, parse_hostfile, parse_hosts
from .http_server import RendezvousServer

log = get_logger(__name__)

LOCAL_HOSTS = ("localhost", "127.0.0.1")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        "python -m horovod_tpu_torch.run",
        description="Launch a horovod_tpu_torch training job",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-v", "--version", action="store_true")
    parser.add_argument("-np", "--num-proc", type=int, dest="np",
                        help="total number of ranks (chips)")
    parser.add_argument("-H", "--hosts", dest="hosts",
                        help="host names and slot counts, e.g. h1:8,h2:8")
    parser.add_argument("--hostfile", dest="hostfile",
                        help="hostfile with lines 'host slots=N'")
    parser.add_argument("--tpu", action="store_true", dest="tpu",
                        help="resolve hosts from TPU pod metadata "
                             "(HVD_TPU_HOSTS / TPU_WORKER_HOSTNAMES / "
                             "GCE metadata) instead of -H")
    parser.add_argument("--output-filename", dest="output_filename",
                        help="per-rank stdout/stderr capture directory")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--config-file", dest="config_file",
                        help="YAML config overriding CLI defaults")
    parser.add_argument("--start-timeout", type=int, default=600)
    parser.add_argument("--ssh-port", type=int, dest="ssh_port")
    parser.add_argument("--disable-cache", action="store_true")
    parser.add_argument("--restarts", type=int, dest="restarts", default=0,
                        help="supervised-restart budget: relaunch the whole "
                             "job up to N times after a failure, with "
                             "exponential backoff; HVD_RESTART_COUNT is "
                             "exported so ElasticState.resume() restores "
                             "the latest checkpoint (docs/fault_tolerance.md)")
    parser.add_argument("--elastic", action="store_true", dest="elastic",
                        help="elastic membership: on a worker failure, "
                             "shrink the world and let survivors rebuild "
                             "in process (no relaunch) instead of killing "
                             "the job; spare hosts that announce at the "
                             "rendezvous are admitted at epoch boundaries "
                             "(docs/fault_tolerance.md).  Composes with "
                             "--restarts: a full relaunch only happens "
                             "when the world would drop below --min-np")
    parser.add_argument("--min-np", type=int, dest="min_np",
                        help="elastic floor: give the job up (fail-stop) "
                             "when the world would shrink below this many "
                             "workers (default 1; HVD_ELASTIC_MIN_NP)")
    parser.add_argument("--serve", action="store_true", dest="serve",
                        help="serving plane: attach the inference "
                             "request router to the launcher rendezvous "
                             "server (signed POST /infer, GET /serving) "
                             "and export the HVD_SERVE_* knobs to "
                             "workers, which pull request batches as "
                             "continuous-batching replicas "
                             "(docs/inference.md).  With --elastic "
                             "+ --serve-autoscale, queue depth and "
                             "p99-vs-SLO headroom grow/shrink the "
                             "replica fleet through membership epochs")
    parser.add_argument("--serve-max-batch", type=int,
                        dest="serve_max_batch",
                        help="continuous batcher admission cap "
                             "(HVD_SERVE_MAX_BATCH)")
    parser.add_argument("--serve-max-wait-ms", type=float,
                        dest="serve_max_wait_ms",
                        help="batch flush deadline from first admit "
                             "(HVD_SERVE_MAX_WAIT_MS)")
    parser.add_argument("--serve-slo-ms", type=float,
                        dest="serve_slo_ms",
                        help="p99 latency objective the autoscaler "
                             "defends (HVD_SERVE_SLO_MS)")
    parser.add_argument("--serve-autoscale", action="store_true",
                        dest="serve_autoscale",
                        help="let the serving autoscaler commit "
                             "grow/shrink membership epochs from load "
                             "(needs --elastic; spares announced via "
                             "join_world are held for it)")
    parser.add_argument("--relay", action="store_true", dest="relay",
                        help="control-plane relay tree: local rank 0 on "
                             "each host aggregates heartbeat renewals, "
                             "metric snapshots, and sanitizer "
                             "fingerprints into batched upstream PUTs "
                             "(HVD_RELAY=1, docs/control_plane.md) — "
                             "steady-state rendezvous traffic drops from "
                             "O(ranks) to O(hosts) requests per interval")
    parser.add_argument("--journal", dest="journal", metavar="PATH",
                        help="append every rendezvous KV mutation to this "
                             "file (HVD_RENDEZVOUS_JOURNAL) so a warm "
                             "standby (scripts/hvd_standby.py) can replay "
                             "it and take over on launcher death; pair "
                             "with HVD_RENDEZVOUS_ADDRS listing "
                             "primary,standby for client failover")
    parser.add_argument("--controller", dest="controller",
                        choices=["auto", "xla", "native"], default="auto",
                        help="eager control plane: 'native' runs the C++ "
                             "negotiation controller (multi-process jobs "
                             "get it by default); 'xla' relies on the "
                             "compiled schedule only")
    parser.add_argument("--dry-run", action="store_true", dest="dry_run",
                        help="print the worker launch plan (env + command "
                             "per process) without spawning anything")
    parser.add_argument("-cb", "--check-build", action="store_true",
                        dest="check_build",
                        help="print available frameworks / controllers / "
                             "tensor operations and exit (reference "
                             "horovodrun --check-build)")
    parser.add_argument("--network-interface", dest="network_interface",
                        help="network interface(s) the host data plane "
                             "advertises on workers (reference "
                             "--network-interface; the first name that "
                             "resolves on each worker wins)")

    group_params = parser.add_argument_group("tuneable parameter arguments")
    group_params.add_argument("--fusion-threshold-mb", type=float,
                              dest="fusion_threshold_mb")
    group_params.add_argument("--cycle-time-ms", type=float,
                              dest="cycle_time_ms")
    group_params.add_argument("--cache-capacity", type=int,
                              dest="cache_capacity")
    group_params.add_argument("--hierarchical-allreduce", action="store_true",
                              dest="hierarchical_allreduce")
    group_params.add_argument("--hierarchical-allgather", action="store_true",
                              dest="hierarchical_allgather")
    group_params.add_argument("--compression", dest="compression",
                              choices=["none", "bf16", "fp16", "int8",
                                       "fp8", "fp8_e5m2"],
                              help="gradient wire format (error-feedback "
                                   "residual carried for the quantized "
                                   "formats; docs/compression.md)")
    group_params.add_argument("--no-error-feedback", action="store_true",
                              dest="no_error_feedback",
                              help="drop the error-feedback residual "
                                   "carry (debug; quantized formats "
                                   "then bias the gradient)")
    group_params.add_argument("--two-level-allreduce", action="store_true",
                              dest="two_level_allreduce",
                              help="ICI reduce-scatter + compressed DCN "
                                   "all-reduce + ICI all-gather gradient "
                                   "path (docs/compression.md)")
    group_params.add_argument("--ring-min-bytes", type=int,
                              dest="ring_min_bytes",
                              help="host-plane payloads at or above this "
                                   "ride the peer ring; below it the "
                                   "coordinator star wins on latency "
                                   "(calibrate with scripts/"
                                   "host_plane_bench.py --crossover)")

    group_at = parser.add_argument_group("autotune arguments")
    group_at.add_argument("--autotune", action="store_true")
    group_at.add_argument("--autotune-log-file", dest="autotune_log_file")
    group_at.add_argument("--autotune-warmup-samples", type=int,
                          dest="autotune_warmup_samples")
    group_at.add_argument("--autotune-steps-per-sample", type=int,
                          dest="autotune_steps_per_sample")
    group_at.add_argument("--autotune-bayes-opt-max-samples", type=int,
                          dest="autotune_bayes_opt_max_samples")
    group_at.add_argument("--autotune-gaussian-process-noise", type=float,
                          dest="autotune_gaussian_process_noise")
    group_at.add_argument("--profile-guided", action="store_true",
                          dest="profile_guided",
                          help="close the replay->autotune loop: plan "
                               "fusion buckets from the job's own trace "
                               "window, apply live, verify predicted vs "
                               "realized (docs/autotune.md; needs "
                               "--timeline-filename)")
    group_at.add_argument("--autotune-window-steps", type=int,
                          dest="autotune_window_steps")
    group_at.add_argument("--autotune-guard-band-pct", type=float,
                          dest="autotune_guard_band_pct")

    group_tl = parser.add_argument_group("timeline arguments")
    group_tl.add_argument("--timeline-filename", dest="timeline_filename")
    group_tl.add_argument("--timeline-mark-cycles", action="store_true",
                          dest="timeline_mark_cycles")
    group_tl.add_argument("--trace-start-step", type=int,
                          dest="trace_start_step")
    group_tl.add_argument("--trace-end-step", type=int, dest="trace_end_step")

    group_st = parser.add_argument_group("stall check arguments")
    group_st.add_argument("--no-stall-check", action="store_true",
                          dest="no_stall_check")
    group_st.add_argument("--stall-check-warning-time-seconds", type=int,
                          dest="stall_check_warning_time_seconds")
    group_st.add_argument("--stall-check-shutdown-time-seconds", type=int,
                          dest="stall_check_shutdown_time_seconds")

    group_log = parser.add_argument_group("logging arguments")
    group_log.add_argument("--log-level", dest="log_level",
                           choices=["trace", "debug", "info", "warning",
                                    "error", "fatal"])
    group_log.add_argument("--log-hide-timestamp", action="store_true",
                           dest="log_hide_timestamp")

    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the training command")

    args = parser.parse_args(argv)

    if args.config_file:
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(
                f"--config-file {args.config_file}: reading the YAML config "
                "needs the yaml package (PyYAML), which is not installed; "
                "pass the options on the command line instead") from e

        with open(args.config_file) as f:
            cfg = yaml.safe_load(f) or {}
        explicit = _explicit_dests(argv if argv is not None else sys.argv[1:],
                                   parser)
        config_parser.set_args_from_config(args, cfg, explicit)
    return args


def _explicit_dests(argv: List[str], parser: argparse.ArgumentParser) -> set:
    """Which dests the user passed on the command line (so YAML doesn't
    override them — reference run/run.py:609-613 override_args)."""
    explicit = set()
    opts = {}
    for action in parser._actions:  # noqa: SLF001
        for opt in action.option_strings:
            opts[opt] = action.dest
    for tok in argv:
        key = tok.split("=")[0]
        if key in opts:
            explicit.add(opts[key])
    return explicit


def _resolve_hosts(args) -> List[HostInfo]:
    if args.hostfile:
        return parse_hostfile(args.hostfile)
    if args.hosts:
        return parse_hosts(args.hosts)
    if getattr(args, "tpu", False):
        # pod-slice host resolution from TPU metadata/env (SURVEY §7.1's
        # replacement for the reference's ssh/NIC probing,
        # reference run/run.py:62-115,198-268)
        from .discovery import discover_tpu_hosts

        found = discover_tpu_hosts()
        if found:
            return found
        raise RuntimeError(
            "--tpu: no pod hosts discoverable (HVD_TPU_HOSTS / "
            "TPU_WORKER_HOSTNAMES / metadata server all empty)"
        )
    # default: all local slots on this machine
    np = args.np or 1
    return [HostInfo("localhost", np)]


def worker_envs(slots: List[SlotInfo], base_env: Dict[str, str],
                coordinator: str, *,
                controller: str = "auto") -> List[Dict[str, str]]:
    """Per-slot worker env dicts, one process per card (reference
    gloo_run.py:210-216 sets HOROVOD_RANK/SIZE/LOCAL_RANK/... per slot;
    the JAX reference's ``worker_envs`` gives a process per *host*, each
    owning that host's chips, run.py:294-346).

    Every slot gets ``HVD_PROCESS_ID`` = its rank, ``HVD_NUM_PROCESSES``
    = the world size and ``HVD_LOCAL_RANK`` / ``HVD_LOCAL_SIZE`` /
    ``HVD_CROSS_RANK`` / ``HVD_CROSS_SIZE`` from the slot table
    (``hosts.allocate_slots``), plus ``HVD_COORDINATOR_ADDR`` =
    ``coordinator`` (the launcher's store, joined as a client:
    ``HVD_COORDINATOR_SERVER=external``) whenever the world has more
    than one process.

    ``controller``: the eager control plane.  ``auto`` is the port's
    ``torch.distributed`` plane, exported under the reference's name for
    it, ``xla``, on a single host; on more than one host the reference
    resolves it to ``native``, which the port has not ported (ROADMAP
    item 17b) and refuses, as it refuses ``native``; the reference's
    ``controller_addr`` and ``elastic`` parameters come with items 17b
    and 13.
    """
    hosts = {s.hostname for s in slots}
    if controller == "auto":
        controller = "native" if len(hosts) > 1 else "xla"
    _refuse_controller(controller, len(hosts))
    size = len(slots)
    envs = []
    for s in slots:
        env = dict(base_env)
        env.update({
            env_util.HVD_RANK: str(s.rank),
            env_util.HVD_SIZE: str(s.size),
            env_util.HVD_LOCAL_RANK: str(s.local_rank),
            env_util.HVD_LOCAL_SIZE: str(s.local_size),
            env_util.HVD_CROSS_RANK: str(s.cross_rank),
            env_util.HVD_CROSS_SIZE: str(s.cross_size),
            env_util.HVD_NUM_PROCESSES: str(size),
            env_util.HVD_PROCESS_ID: str(s.rank),
            env_util.HVD_CONTROLLER: controller,
            env_util.HVD_CPU_OPERATIONS: "xla",
        })
        if size > 1:
            env[env_util.HVD_COORDINATOR_ADDR] = coordinator
            env[env_util.HVD_COORDINATOR_SERVER] = "external"
        envs.append(env)
    return envs


def _refuse(what: str, feature: str, item) -> None:
    raise NotImplementedError(
        f"{what}: {feature} is not ported yet (ROADMAP queue 1, item "
        f"{item})")


def _refuse_controller(controller: str, n_hosts: int) -> None:
    """``native`` (asked for, or ``auto`` over more than one host, which
    the reference resolves to it) is the native negotiation controller
    and peer ring, ROADMAP item 17b."""
    if controller == "native":
        _refuse("--controller native" if n_hosts <= 1 else
                f"--controller auto over {n_hosts} hosts (the reference "
                "resolves it to native)",
                "the native negotiation controller", "17b")


def _refuse_unported(args, env: Dict[str, str]) -> None:
    """Raise for every option of ``args`` / ``env`` that names a plane the
    port has not reached yet (see the module docstring)."""
    if getattr(args, "elastic", False) or \
            getattr(args, "min_np", None) is not None:
        _refuse("--elastic / --min-np", "elastic membership", 13)
    serve_opts = [f"--{k.replace('_', '-')}" for k in (
        "serve", "serve_max_batch", "serve_max_wait_ms", "serve_slo_ms",
        "serve_autoscale") if getattr(args, k, None) not in (None, False)]
    if serve_opts or env_util.parse_bool(
            env.get(env_util.HVD_SERVE, os.environ.get(env_util.HVD_SERVE))):
        _refuse(" / ".join(serve_opts) or env_util.HVD_SERVE,
                "the serving plane", 14)
    if env_util.parse_bool(env.get(env_util.HVD_WATCH,
                                   os.environ.get(env_util.HVD_WATCH))):
        _refuse(f"{env_util.HVD_WATCH}=1", "the launcher-side watchdog "
                "(observe/watchdog.py)", 15)


def ssh_command(hostname: str, env: Dict[str, str], command: List[str],
                ssh_port: Optional[int] = None, cwd: Optional[str] = None) -> str:
    """The remote launch line (reference gloo_run.py:142-259 ssh fan-out;
    kept as a pure string builder so tests can assert it without a
    cluster, reference test/test_run.py:259-362)."""
    exports = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in sorted(env.items())
    )
    cd = f"cd {shlex.quote(cwd)} > /dev/null 2>&1 && " if cwd else ""
    port = f" -p {ssh_port}" if ssh_port else ""
    inner = f"{cd}env {exports} {' '.join(shlex.quote(c) for c in command)}"
    return (
        f"ssh -o PasswordAuthentication=no -o StrictHostKeyChecking=no"
        f"{port} {hostname} {shlex.quote(inner)}"
    )


class _Job:
    def __init__(self) -> None:
        self.procs: List[subprocess.Popen] = []
        self.failed: Optional[int] = None
        self.interrupted = False  # operator signal: never auto-restart
        self._lock = threading.Lock()

    def _signal_survivors(self, sig) -> int:
        alive = 0
        with self._lock:
            for p in self.procs:
                if p.poll() is None:
                    alive += 1
                    try:
                        p.send_signal(sig)
                    except OSError:
                        pass
        return alive

    def all_exited(self) -> bool:
        with self._lock:
            return all(p.poll() is not None for p in self.procs)

    def kill_all(self, sig=signal.SIGTERM, *, grace: Optional[float] = None,
                 escalate: bool = True) -> None:
        """Terminate every live worker, escalating SIGTERM→SIGKILL after
        ``grace`` seconds (``HVD_TERM_GRACE_SECONDS``, default 5).  A
        worker wedged in a collective ignores SIGTERM; without the
        escalation the launcher used to leak it."""
        if not self._signal_survivors(sig):
            return
        if not escalate or sig == signal.SIGKILL:
            return
        if grace is None:
            grace = env_util.get_float(env_util.HVD_TERM_GRACE_SECONDS,
                                       env_util.DEFAULT_TERM_GRACE_SECONDS)
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            if self.all_exited():
                return
            time.sleep(0.1)
        survivors = self._signal_survivors(signal.SIGKILL)
        if survivors:
            log.warning("%d worker(s) ignored SIGTERM for %.1fs; sent "
                        "SIGKILL", survivors, grace)


def _supervise(job: _Job, rdv_server: Optional[RendezvousServer],
               poll_interval: float = 0.2) -> int:
    """Event-driven wait on the worker set: react to the FIRST failure,
    whichever rank it is (the old loop blocked in ``procs[0].wait()``, so
    a crashed rank 3 went unnoticed while rank 0 idled in a collective).

    On a failure: publish the coordinated-abort flag on the rendezvous
    server (each rank's heartbeat polls it and raises HorovodAbortError
    at the next dispatch — elastic/heartbeat.py), give survivors one
    heartbeat window to exit with that root cause, then escalate
    SIGTERM→SIGKILL on whatever is left."""
    procs = job.procs
    while True:
        states = [p.poll() for p in procs]
        failures = [(pid, c) for pid, c in enumerate(states)
                    if c is not None and c != 0]
        if failures:
            pid, code = failures[0]
            log.error("worker %d exited with code %d; aborting job",
                      pid, code)
            job.failed = pid
            hb_interval = env_util.get_float(
                env_util.HVD_HEARTBEAT_INTERVAL_SECONDS,
                env_util.DEFAULT_HEARTBEAT_INTERVAL_SECONDS)
            if rdv_server is not None:
                # note: ..elastic re-exports the abort() FUNCTION over the
                # submodule attribute, so names are imported directly
                from ..elastic.abort import ABORT_KEY, ABORT_SCOPE, make_flag

                flag = make_flag(
                    f"worker {pid} exited with code {code}",
                    rank=pid, source="launcher",
                )
                # flight recorder: the publish event rides the flag so
                # observers chain onto it, and the restart loop chains
                # restart.attempt onto it too (observe/events.py)
                try:
                    from ..observe import events as events_mod

                    eid = events_mod.record_event(
                        "abort.publish", severity="critical",
                        payload={"reason": flag["reason"],
                                 "source": "launcher",
                                 "exit_code": code},
                        rank=pid)
                    if eid:
                        flag["event_id"] = eid
                        corr = events_mod.correlation_of(eid)
                        if corr:
                            flag["correlation_id"] = corr
                        job.abort_event_id = eid
                except Exception:  # noqa: BLE001 — best-effort
                    pass
                rdv_server.put(ABORT_SCOPE, ABORT_KEY,
                               json.dumps(flag).encode())
                # survivors poll the flag once per heartbeat interval and
                # raise at their next step/dispatch seam; the exit budget
                # is two intervals plus the term grace (a rank mid-save
                # needs the slack), matching the documented bound of
                # 2 x HVD_HEARTBEAT_INTERVAL_SECONDS + grace
                grace = env_util.get_float(
                    env_util.HVD_TERM_GRACE_SECONDS,
                    env_util.DEFAULT_TERM_GRACE_SECONDS)
                deadline = time.monotonic() + 2.0 * hb_interval + grace
                while time.monotonic() < deadline and not job.all_exited():
                    time.sleep(0.1)
            job.kill_all()
            return code
        if all(c == 0 for c in states):
            return 0
        time.sleep(poll_interval)


def _launch_attempt(args, hosts: List[str], envs: List[Dict[str, str]],
                    rdv_server: Optional[RendezvousServer],
                    attempt: int = 0) -> int:
    """Spawn one incarnation of the worker set, ``hosts[i]`` running
    process ``i``, and supervise it to exit."""
    job = _Job()

    def handler(signum, frame):
        job.interrupted = True
        job.kill_all(signal.SIGTERM)

    old_int = signal.signal(signal.SIGINT, handler)
    old_term = signal.signal(signal.SIGTERM, handler)

    threads = []
    try:
        for pid, hostname in enumerate(hosts):
            wenv = envs[pid]
            if hostname in LOCAL_HOSTS:
                full_env = dict(os.environ)
                full_env.update(wenv)
                proc = subprocess.Popen(
                    args.command, env=full_env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
            else:
                cmd = ssh_command(hostname, wenv, args.command,
                                  ssh_port=args.ssh_port, cwd=os.getcwd())
                proc = subprocess.Popen(
                    cmd, shell=True,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
            job.procs.append(proc)

            t = threading.Thread(
                target=_pump_output,
                args=(proc, pid, args.output_filename, attempt),
                daemon=True,
            )
            t.start()
            threads.append(t)

        rc = _supervise(job, rdv_server)
        for t in threads:
            t.join(timeout=5)
        if job.interrupted and rc == 0:
            rc = 130  # operator interrupt must not read as success
        args._interrupted = job.interrupted  # noqa: SLF001 — restart gate
        args._abort_event_id = getattr(  # noqa: SLF001 — restart.attempt
            job, "abort_event_id", None)  # chains onto this publish
        return rc
    finally:
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)


def launch_job(args, slots: List[SlotInfo], env: Dict[str, str]) -> int:
    """Stand up the job's rendezvous plane, then spawn + supervise the
    worker set, one process a slot, relaunching up to ``--restarts``
    times on failure (reference gloo_run.py:142-259, plus the
    failure-domain runtime of docs/fault_tolerance.md)."""
    _refuse_unported(args, env)
    hosts = sorted({s.hostname for s in slots},
                   key=[s.hostname for s in slots].index)
    local = all(h in LOCAL_HOSTS for h in hosts)
    controller = getattr(args, "controller", "auto") or "auto"
    if controller == "auto":
        controller = "native" if len(hosts) > 1 else "xla"
    _refuse_controller(controller, len(hosts))

    # Rendezvous/aggregation point: the launcher hosts one server that
    # carries metrics pushes (GET /metrics), heartbeat leases + the abort
    # flag (GET /health), events, profiles and plans.  It exists whenever
    # metrics OR heartbeats want it.
    rdv_server = None
    metrics_on = env_util.parse_bool(
        env.get(env_util.HVD_METRICS, os.environ.get(env_util.HVD_METRICS)),
        True,
    )
    heartbeat_on = not env_util.parse_bool(
        env.get(env_util.HVD_HEARTBEAT_DISABLE,
                os.environ.get(env_util.HVD_HEARTBEAT_DISABLE)),
        False,
    )
    # An operator-provided HVD_METRICS_KV_ADDR means an external
    # aggregation server: forward the operator's values untouched.
    external_sink = env.get(
        env_util.HVD_METRICS_KV_ADDR,
        os.environ.get(env_util.HVD_METRICS_KV_ADDR),
    )
    if not getattr(args, "dry_run", False) and (metrics_on or heartbeat_on) \
            and not external_sink:
        # operator-provided secret (hex) wins so their tooling can sign
        # scrapes; otherwise generate one and LOG it — a secret nobody
        # knows makes the advertised endpoint unusable
        secret_hex = env.get(env_util.HVD_METRICS_SECRET,
                             os.environ.get(env_util.HVD_METRICS_SECRET))
        try:
            rdv_secret = bytes.fromhex(secret_hex) if secret_hex \
                else _secrets.token_bytes(16)
        except ValueError:
            raise ValueError(
                f"{env_util.HVD_METRICS_SECRET} must be hex, got "
                f"{secret_hex!r}"
            )
        journal_path = getattr(args, "journal", None) \
            or env.get(env_util.HVD_RENDEZVOUS_JOURNAL,
                       os.environ.get(env_util.HVD_RENDEZVOUS_JOURNAL))
        rdv_server = RendezvousServer(secret=rdv_secret,
                                      journal_path=journal_path)
        rdv_port = rdv_server.start()
        # flight recorder: launcher-side events land straight in the
        # journaled `events` scope (observe/events.py, GET /events)
        from ..observe import events as events_mod

        events_mod.attach_server(rdv_server)
        rdv_host = "127.0.0.1" if local else socket.gethostname()
        env = dict(env)
        env[env_util.HVD_METRICS_KV_ADDR] = rdv_host
        env[env_util.HVD_METRICS_KV_PORT] = str(rdv_port)
        env[env_util.HVD_METRICS_SECRET] = rdv_secret.hex()
        # ordered failover list for workers: the operator's
        # primary,standby list wins (warm standby via --journal);
        # otherwise advertise the primary so every client resolves
        # addresses one way
        env.setdefault(
            env_util.HVD_RENDEZVOUS_ADDRS,
            os.environ.get(env_util.HVD_RENDEZVOUS_ADDRS)
            or f"{rdv_host}:{rdv_port}")
        if journal_path:
            log.info("rendezvous journal at %s (a warm standby replays "
                     "it with run.journal.replay)", journal_path)
        if metrics_on:
            # never echo an operator-provided credential into job logs; a
            # generated one must be printed or the endpoint is unusable
            secret_expr = "bytes.fromhex(os.environ['HVD_METRICS_SECRET'])" \
                if secret_hex else f"bytes.fromhex('{rdv_secret.hex()}')"
            log.info(
                "metrics: signed GET http://%s:%d/metrics aggregates all "
                "ranks — e.g. horovod_tpu_torch.run.http_client.get_metrics("
                "'%s', %d, secret=%s)",
                rdv_host, rdv_port, rdv_host, rdv_port,
                secret_expr,
            )
        if heartbeat_on:
            log.info("health: GET http://%s:%d/health reports per-rank "
                     "lease verdicts", rdv_host, rdv_port)
    if getattr(args, "relay", False):
        env = dict(env)
        env[env_util.HVD_RELAY] = "1"

    proc_hosts = [s.hostname for s in slots]
    if getattr(args, "dry_run", False):
        envs = worker_envs(slots, env, "<launcher>:<bound-at-launch>",
                           controller=controller)
        for pid, hostname in enumerate(proc_hosts):
            print(f"[dry-run] process {pid} on {hostname}:")
            for k in sorted(set(envs[pid]) - set(env)):
                print(f"  {k}={envs[pid][k]}")
            print(f"  command: {' '.join(args.command)}")
        return 0

    restarts = getattr(args, "restarts", 0) or 0
    backoff_base = env_util.get_float(env_util.HVD_RESTART_BACKOFF_SECONDS,
                                      env_util.DEFAULT_RESTART_BACKOFF_SECONDS)
    attempt = 0
    try:
        while True:
            # the job's store is per incarnation: a failed attempt leaves
            # its ranks' keys behind, and a restart rendezvouses afresh
            host = "127.0.0.1" if local else socket.gethostname()
            store = _coordinator_store(len(slots), host)
            coordinator = "" if store is None else f"{host}:{store.port}"
            env_attempt = dict(env)
            env_attempt[env_util.HVD_RESTART_COUNT] = str(attempt)
            envs = worker_envs(slots, env_attempt, coordinator,
                               controller=controller)
            try:
                rc = _launch_attempt(args, proc_hosts, envs, rdv_server,
                                     attempt=attempt)
            finally:
                del store  # the TCPStore server stops with its object
            if rc == 0 or attempt >= restarts \
                    or getattr(args, "_interrupted", False):
                if rc != 0 and getattr(args, "_interrupted", False):
                    log.info("job interrupted by operator signal; not "
                             "restarting")
                return rc
            attempt += 1
            from .. import metrics as metrics_mod

            if metrics_mod.on():
                metrics_mod.RESTARTS.inc()
            # flight recorder: chain the relaunch onto the launcher's
            # abort publish that ended the attempt (observe/events.py)
            try:
                from ..observe import events as events_mod

                events_mod.record_event(
                    "restart.attempt", severity="warning",
                    payload={"attempt": attempt, "restarts": restarts,
                             "exit_code": rc},
                    cause_id=getattr(args, "_abort_event_id", None))
            except Exception:  # noqa: BLE001 — best-effort
                pass
            delay = backoff_base * (2 ** (attempt - 1)) \
                + random.uniform(0.0, backoff_base)
            log.warning(
                "restarting job (attempt %d/%d) in %.1fs after exit code "
                "%d; workers resume from their latest checkpoint "
                "(HVD_RESTART_COUNT=%d)", attempt, restarts, delay, rc,
                attempt,
            )
            time.sleep(delay)
            if rdv_server is not None:
                # a stale abort flag, dead lease, or last-attempt
                # membership record must not kill the fresh incarnation
                # at its first heartbeat
                from .http_server import (
                    ABORT_SCOPE,
                    HEALTH_SCOPE,
                    MEMBERSHIP_SCOPE,
                )

                rdv_server.clear_scope(ABORT_SCOPE)
                rdv_server.clear_scope(HEALTH_SCOPE)
                rdv_server.clear_scope(MEMBERSHIP_SCOPE)
    finally:
        if rdv_server is not None:
            rdv_server.stop()


def _coordinator_store(size: int, host: str):
    """The job's ``torch.distributed`` store for a world of ``size``
    processes, served by this process on a port it binds itself (port 0)
    and reached by the ranks at ``host``,
    or None for one process (which needs none).  The ranks join it as
    clients (``HVD_COORDINATOR_SERVER=external``)."""
    if size <= 1:
        return None
    import datetime

    import torch.distributed as dist

    timeout = env_util.get_float(env_util.HVD_START_TIMEOUT,
                                 env_util.DEFAULT_START_TIMEOUT_SECONDS)
    return dist.TCPStore(host, 0, None, True,
                         timeout=datetime.timedelta(seconds=timeout),
                         wait_for_workers=False)


def _pump_output(proc: subprocess.Popen, pid: int,
                 output_dir: Optional[str], attempt: int = 0) -> None:
    """Tag each line with the worker index (mpirun --tag-output style,
    reference mpi_run.py:115-149) and/or tee to per-rank files
    (reference gloo_run.py output capture).  Restart attempts get their
    own files — truncating rank.N.txt on relaunch would destroy the very
    crash diagnostics the restart was for."""
    sink = None
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        name = f"rank.{pid}.txt" if attempt == 0 \
            else f"rank.{pid}.restart{attempt}.txt"
        sink = open(os.path.join(output_dir, name), "w")
    assert proc.stdout is not None
    for line in proc.stdout:
        sys.stdout.write(f"[{pid}]<stdout>: {line}")
        sys.stdout.flush()
        if sink:
            sink.write(line)
            sink.flush()
    if sink:
        sink.close()


def check_build() -> str:
    """Availability report (reference run/run.py:289-324 check_build) of
    the port's own stack: PyTorch and its CUDA, ``torch.distributed``'s
    backends, ``nvcc``, whether the Hopper kernels' library is built and
    the native core (``runtime/native.py``).  Probes only: nothing is
    built or launched."""
    import importlib.util
    import shutil

    import torch
    import torch.distributed as dist

    from .. import __version__, kernels
    from ..runtime import native

    def mark(ok):
        return "X" if ok else " "

    def has(mod):
        return importlib.util.find_spec(mod) is not None

    nvcc = shutil.which("nvcc") or (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"))
    nvcc_ok = os.path.exists(nvcc)
    cuda = torch.version.cuda
    return f"""\
horovod_tpu_torch v{__version__}:

Available Frameworks:
    [{mark(True)}] PyTorch {torch.__version__}
    [{mark(cuda is not None)}] CUDA {cuda or '(CPU-only build)'}
    [{mark(torch.cuda.is_available())}] a CUDA device \
({torch.cuda.device_count()} visible)

Available Controllers:
    [{mark(dist.is_available())}] torch.distributed (TCPStore rendezvous)
    [ ] native (C++ TCP negotiation, ROADMAP item 17b)

Available Tensor Operations:
    [{mark(dist.is_available() and dist.is_nccl_available())}] NCCL
    [{mark(dist.is_available() and dist.is_gloo_available())}] gloo

Kernels (horovod_tpu_torch/csrc, sm_90a):
    [{mark(nvcc_ok)}] nvcc ({nvcc if nvcc_ok else 'not found'})
    [{mark(kernels.LIB_PATH.exists())}] {kernels.LIB_PATH.name} built
    [{mark(has('triton'))}] triton
    [{mark(native.SO_PATH.exists())}] native core ({native.SO_PATH.name} \
built; make -C csrc at first use)"""


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.version:
        from .. import __version__

        print(__version__)
        return 0
    if getattr(args, "check_build", False):
        print(check_build())
        return 0
    if not args.command:
        print("horovod_tpu_torch.run: no command given", file=sys.stderr)
        return 2
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    hosts = _resolve_hosts(args)
    np = args.np or sum(h.slots for h in hosts)
    slots = allocate_slots(hosts, np)
    env = config_parser.env_from_args(args)
    if args.verbose:
        env[env_util.HVD_LOG_LEVEL] = env.get(env_util.HVD_LOG_LEVEL, "debug")
    return launch_job(args, slots, env)


# ---------------------------------------------------------------------------
# function mode: horovod_tpu_torch.run.run(fn, args=(), np=...)
# ---------------------------------------------------------------------------
def _dumps_fn(payload) -> bytes:
    """``(fn, args, kwargs)`` pickled: with ``cloudpickle`` where it is
    installed (a lambda or closure then ships too; reference
    run/common/util/codec.py), else with the standard ``pickle``, which
    carries an importable function by reference."""
    try:
        import cloudpickle
    except ImportError:
        try:
            return pickle.dumps(payload)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError(
                "function mode ships fn with the standard pickle because "
                "cloudpickle is not installed, and pickle cannot carry "
                f"this one ({e}); pass a function defined at the top level "
                "of an importable module") from e
    return cloudpickle.dumps(payload)


def run(fn, args=(), kwargs=None, np: int = 1,
        extra_env: Optional[Dict[str, str]] = None):
    """Run ``fn(*args, **kwargs)`` on ``np`` local worker processes and
    return the per-process results (reference run/run.py:870-956: the fn is
    pickled, shipped through the KV store, executed by each rank, results
    collected back through the KV store).  For ``np > 1`` the workers
    join this process's ``torch.distributed`` store
    (``HVD_COORDINATOR_ADDR``) when ``fn`` calls ``init``."""
    kwargs = kwargs or {}
    extra_env = dict(extra_env or {})
    _refuse_unported(argparse.Namespace(), extra_env)
    _refuse_controller(extra_env.get(
        env_util.HVD_CONTROLLER,
        os.environ.get(env_util.HVD_CONTROLLER, "xla")), 1)
    blob = _dumps_fn((fn, args, kwargs))
    secret = _secrets.token_bytes(16)
    server = RendezvousServer(
        secret=secret,
        journal_path=extra_env.get(
            env_util.HVD_RENDEZVOUS_JOURNAL,
            os.environ.get(env_util.HVD_RENDEZVOUS_JOURNAL)))
    port = server.start()
    # same flight-recorder wiring as launch_job (observe/events.py)
    from ..observe import events as _events_mod

    _events_mod.attach_server(server)
    # Multi-process workers need an eager transport: the port's
    # torch.distributed group on a store this process serves (port 0,
    # bound here: no races), unless the caller named one.
    store = None
    if np > 1 and not extra_env.get(env_util.HVD_COORDINATOR_ADDR):
        store = _coordinator_store(np, "127.0.0.1")
        extra_env[env_util.HVD_COORDINATOR_ADDR] = f"127.0.0.1:{store.port}"
        extra_env[env_util.HVD_COORDINATOR_SERVER] = "external"
    # Live metrics: point workers' pushers at this server, so a scrape of
    # GET /metrics here aggregates every rank while fn runs (the final
    # snapshot is pushed by task_fn regardless).
    extra_env.setdefault(env_util.HVD_METRICS_KV_ADDR, "127.0.0.1")
    extra_env.setdefault(env_util.HVD_METRICS_KV_PORT, str(port))
    extra_env.setdefault(env_util.HVD_METRICS_SECRET, secret.hex())
    server.put("job", "fn", blob)

    procs = []
    try:
        for pid in range(np):
            env = dict(os.environ)
            env.update(extra_env)
            env.update({
                "HVD_RUN_KV_ADDR": "127.0.0.1",
                "HVD_RUN_KV_PORT": str(port),
                "HVD_RUN_SECRET": secret.hex(),
                "HVD_RUN_PID": str(pid),
                "HVD_RUN_NP": str(np),
                env_util.HVD_RANK: str(pid),
                env_util.HVD_SIZE: str(np),
                env_util.HVD_NUM_PROCESSES: str(np),
                env_util.HVD_PROCESS_ID: str(pid),
            })
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.run.task_fn"],
                env=env,
            ))
        # Supervise like launch_job: react to the FIRST failure, whichever
        # worker it is — a rank-order wait would hang here forever while a
        # surviving worker blocks in a collective its dead peer never
        # joins.  The abort flag goes onto this server so the survivors'
        # heartbeats surface the root cause before the escalating kill.
        job = _Job()
        job.procs = procs
        rc = _supervise(job, server, poll_interval=0.1)
        rcs = [p.wait() for p in procs]
        if rc or any(rcs):
            # surface the tracebacks the workers published before exiting
            errors = []
            for pid in range(np):
                blob = server.get("result", str(pid))
                if blob is not None:
                    payload = pickle.loads(blob)
                    if payload.get("error"):
                        errors.append(f"[worker {pid}] {payload['error']}")
            raise RuntimeError(
                "function-mode workers failed: rcs=%s\n%s"
                % (rcs, "\n".join(errors))
            )
        results = []
        for pid in range(np):
            blob = server.get("result", str(pid))
            if blob is None:
                raise RuntimeError(f"worker {pid} returned no result")
            payload = pickle.loads(blob)
            if payload.get("error"):
                raise RuntimeError(
                    f"worker {pid} raised: {payload['error']}"
                )
            results.append(payload["value"])
        return results
    finally:
        # escalating teardown: SIGTERM, grace, then SIGKILL — a worker
        # wedged in a collective ignores SIGTERM and would leak
        if any(p.poll() is None for p in procs):
            grace_job = _Job()
            grace_job.procs = procs
            grace_job.kill_all()
        del store
        server.stop()


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
