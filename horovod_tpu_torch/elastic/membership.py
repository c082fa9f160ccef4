"""Elastic membership: the worker side of shrink/grow worlds — the port
of ``horovod_tpu/elastic/membership.py``.

The failure-domain runtime alone is fail-stop: a dead rank aborts the
whole job and ``--restarts`` relaunches everything — correct, but every
failure costs a full teardown, a new CUDA context and graph capture on
all ranks, and up to one checkpoint interval of work on every survivor.
This module is the in-process alternative, the form of the reference's
elastic runtime (``hvd.elastic``: discovery-driven worker sets,
``@hvd.elastic.run`` state restore — reference
horovod/run/elastic/driver.py, horovod/common/elastic.py):

* The **elastic driver** (elastic/driver.py, hosted by the launcher's
  ``--elastic`` supervisor) owns the world.  Membership is versioned by
  an **epoch counter**: each committed epoch is a JSON record at the
  rendezvous key ``/membership/epoch`` —
  ``{"epoch": N, "world": [worker ids in rank order], "controller_addr",
  "coordinator_addr", "removed", "admitted", "reason"}``.  The port's
  record also names the epoch's own ``torch.distributed`` store
  (``coordinator_addr`` → ``HVD_COORDINATOR_ADDR``): each world joins a
  fresh ``TCPStore``, as each restart attempt does, so no key of a dead
  world can meet the new one.  Worker identity
  (``HVD_ELASTIC_WORKER_ID``) is stable across epochs; *ranks* are
  re-assigned densely from the roster order each epoch.
* On a failure the driver revokes the dead rank's lease, publishes the
  coordinated-abort flag stamped with the dying epoch, and commits epoch
  N+1 with the survivor roster.  Survivors raise
  :class:`~horovod_tpu_torch.elastic.abort.HorovodAbortError` at the
  next dispatch/step seam; the :func:`run` wrapper catches it, waits for
  the new epoch, **rebuilds in process** (:func:`apply_epoch` →
  ``core.reinit()``: the old process group destroyed, the new one joined,
  every built train step's graph released first and rebuilt at its next
  call), re-syncs :class:`~horovod_tpu_torch.elastic.state.ElasticState`
  through a rank-0 in-memory broadcast (no disk round trip), and retries
  the training function.
* Rejoin is the same path in reverse: a restarted or spare host calls
  :func:`join_world`, which announces it at the rendezvous; the driver
  admits it at the next epoch boundary, and the newcomer receives the
  live state from the same rank-0 broadcast (checkpoint restore is only
  the fallback when no broadcast arrives).

Wire layout under the ``membership`` scope (run/http_server.py;
``GET /membership`` renders it all):

====================  =====================================================
key                   value
====================  =====================================================
``epoch``             the committed epoch record (single writer: the driver)
``announce.<worker>`` a rejoin candidacy ``{worker, host, pid, time}``
``ready.<N>.<worker>``worker's ack that it rebuilt into epoch N
``state.<N>``         rank 0's pickled ``{state, step}`` broadcast for N
``blocklist``         worker ids barred from rejoining (flapping hosts)
====================  =====================================================
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import time
import urllib.error
from typing import Any, Callable, Optional

from ..utils import env as env_util
from ..utils.logging import get_logger
from .abort import HorovodAbortError, _rendezvous_from_env

log = get_logger(__name__)

# module state: the epoch this process last applied, and its identity.
_epoch: int = 0
_record: Optional[dict] = None
_worker_id: Optional[str] = None


class RemovedFromWorldError(HorovodAbortError):
    """This worker is not part of the committed epoch (it was removed or
    blocklisted by the elastic driver) — there is nothing to rebuild
    into; the process must exit."""


def enabled() -> bool:
    """True when an elastic driver supervises this job (HVD_ELASTIC=1)."""
    return env_util.get_bool(env_util.HVD_ELASTIC)


def worker_id() -> str:
    """This process's stable identity across epochs: the launcher exports
    ``HVD_ELASTIC_WORKER_ID``; spare hosts set their own; the initial
    process id is the fallback."""
    global _worker_id
    if _worker_id is None:
        _worker_id = env_util.get_str(env_util.HVD_ELASTIC_WORKER_ID) \
            or str(env_util.get_int(env_util.HVD_PROCESS_ID, 0))
    return _worker_id


def current_epoch() -> int:
    return _epoch


def current_record() -> Optional[dict]:
    return _record


def world_size() -> int:
    """Size of the committed world this process last applied (falls back
    to the launcher-exported process count before any epoch is seen)."""
    if _record is not None:
        return len(_record.get("world", ()))
    return env_util.get_int(env_util.HVD_NUM_PROCESSES, 1)


def elastic_timeout() -> float:
    return env_util.get_float(env_util.HVD_ELASTIC_TIMEOUT_SECONDS,
                              env_util.DEFAULT_ELASTIC_TIMEOUT_SECONDS)


def _wiring():
    wired = _rendezvous_from_env()
    if wired is None:
        raise RuntimeError(
            "elastic membership needs the launcher rendezvous wiring "
            "(HVD_METRICS_KV_ADDR/PORT); was this process started under "
            "the launcher's --elastic or pointed at its server?"
        )
    return wired


def get_epoch_record(*, timeout: float = 0.0) -> Optional[dict]:
    """The committed epoch record from the rendezvous server (None when
    nothing is committed yet; ``timeout`` waits for the first commit)."""
    from ..run.http_client import get_kv
    from ..run.http_server import EPOCH_KEY, MEMBERSHIP_SCOPE

    addr, port, secret = _wiring()
    raw = get_kv(addr, port, MEMBERSHIP_SCOPE, EPOCH_KEY, secret=secret,
                 wait=timeout > 0, timeout=timeout)
    if raw is None:
        return None
    return json.loads(raw)


def wait_for_epoch(min_epoch: int,
                   timeout: Optional[float] = None) -> Optional[dict]:
    """Poll the rendezvous until an epoch ``>= min_epoch`` is committed;
    returns the record, or None when ``timeout`` (default
    ``HVD_ELASTIC_TIMEOUT_SECONDS``) expires — the caller then treats the
    job as dead rather than waiting forever on a driver that gave up.
    Transient rendezvous errors are absorbed until the deadline."""
    timeout = elastic_timeout() if timeout is None else timeout
    deadline = time.monotonic() + timeout
    delay = 0.05
    while True:
        try:
            rec = get_epoch_record()
            if rec is not None and int(rec.get("epoch", -1)) >= min_epoch:
                return rec
        except (urllib.error.URLError, OSError, ValueError) as e:
            log.debug("membership poll failed: %s", e)
        if time.monotonic() >= deadline:
            return None
        time.sleep(delay)
        delay = min(delay * 1.5, 0.5)


def ack(epoch: int) -> None:
    """Publish this worker's ready ack for ``epoch`` — the driver's
    rebuild barrier (it clears the abort flag and admits pending joins
    once every roster member has acked)."""
    from ..run.http_client import put_kv
    from ..run.http_server import MEMBERSHIP_SCOPE, READY_PREFIX

    addr, port, secret = _wiring()
    put_kv(addr, port, MEMBERSHIP_SCOPE,
           f"{READY_PREFIX}{int(epoch)}.{worker_id()}",
           json.dumps({"worker": worker_id(), "pid": os.getpid(),
                       "time": time.time()}).encode(),
           secret=secret, retry=True)


def announce() -> None:
    """Publish this worker's rejoin candidacy; the driver admits it at
    the next epoch boundary (unless blocklisted) — or holds it as a
    spare when a serving autoscaler owns admissions."""
    from ..run.http_client import put_kv
    from ..run.http_server import ANNOUNCE_PREFIX, MEMBERSHIP_SCOPE

    addr, port, secret = _wiring()
    put_kv(addr, port, MEMBERSHIP_SCOPE, f"{ANNOUNCE_PREFIX}{worker_id()}",
           json.dumps({"worker": worker_id(), "host": socket.gethostname(),
                       "pid": os.getpid(), "time": time.time()}).encode(),
           secret=secret, retry=True)


def drain_requested() -> Optional[dict]:
    """The driver's pending drain request for THIS worker (None when
    there is none): the first half of the lossless scale-down
    handshake — on a request, stop taking new work, finish in flight,
    then :func:`ack_drain` (docs/inference.md, docs/fault_tolerance.md
    "Drain handshake").  Never raises: a rendezvous blip reads as "no
    request" and the driver's timeout covers the lossy fallback."""
    from ..run.http_client import get_kv
    from ..run.http_server import DRAIN_PREFIX, MEMBERSHIP_SCOPE

    try:
        addr, port, secret = _wiring()
        raw = get_kv(addr, port, MEMBERSHIP_SCOPE,
                     f"{DRAIN_PREFIX}{worker_id()}", secret=secret)
    except (RuntimeError, urllib.error.URLError, OSError) as e:
        log.debug("drain poll failed: %s", e)
        return None
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return {"worker": worker_id()}


def ack_drain() -> None:
    """The second half of the drain handshake: this worker has stopped
    pulling and completed everything in flight — the driver may now
    commit the shrink epoch."""
    from ..run.http_client import put_kv
    from ..run.http_server import DRAIN_ACK_PREFIX, MEMBERSHIP_SCOPE

    addr, port, secret = _wiring()
    put_kv(addr, port, MEMBERSHIP_SCOPE,
           f"{DRAIN_ACK_PREFIX}{worker_id()}",
           json.dumps({"worker": worker_id(), "pid": os.getpid(),
                       "time": time.time()}).encode(),
           secret=secret, retry=True)


def notify_preemption(grace: Optional[float] = None) -> None:
    """Publish a preemption notice for THIS worker (cloud maintenance
    signal, or a ``kind=preempt`` fault): ``preempt.<worker>`` under the
    membership scope.  The elastic driver's poll picks it up and runs a
    planned drain+snapshot inside the ``grace`` window
    (elastic/driver.preempt) — the worker keeps working until the drain
    request arrives, so preemption never reads as a crash."""
    from ..run.http_client import put_kv
    from ..run.http_server import MEMBERSHIP_SCOPE, PREEMPT_PREFIX

    addr, port, secret = _wiring()
    put_kv(addr, port, MEMBERSHIP_SCOPE,
           f"{PREEMPT_PREFIX}{worker_id()}",
           json.dumps({"worker": worker_id(), "grace": grace,
                       "pid": os.getpid(), "time": time.time()}).encode(),
           secret=secret, retry=True)


def _apply_env(rec: dict) -> int:
    """Adopt the committed record: re-assign this worker's dense rank
    from the roster and rewrite the topology env the runtime reads.
    Raises :class:`RemovedFromWorldError` when this worker is not in the
    roster.  Returns the new rank."""
    global _epoch, _record
    world = list(rec.get("world", ()))
    me = worker_id()
    if me not in world:
        raise RemovedFromWorldError(
            f"worker {me} is not in the epoch-{rec.get('epoch')} world "
            f"{world} (removed or blocklisted by the elastic driver)"
        )
    new_rank = world.index(me)
    n = len(world)
    os.environ[env_util.HVD_PROCESS_ID] = str(new_rank)
    os.environ[env_util.HVD_RANK] = str(new_rank)
    os.environ[env_util.HVD_NUM_PROCESSES] = str(n)
    os.environ[env_util.HVD_SIZE] = str(n)
    # the record names workers, not hosts: the port's host layout (its
    # processes per host) is dropped, and the new world is one host to
    # core.init
    for key in (env_util.HVD_LOCAL_SIZE, env_util.HVD_LOCAL_RANK,
                env_util.HVD_CROSS_RANK, env_util.HVD_CROSS_SIZE):
        os.environ.pop(key, None)
    ctrl = rec.get("controller_addr")
    if ctrl:
        os.environ[env_util.HVD_CONTROLLER_ADDR] = ctrl
    else:
        os.environ.pop(env_util.HVD_CONTROLLER_ADDR, None)
    store = rec.get("coordinator_addr")
    if store:
        os.environ[env_util.HVD_COORDINATOR_ADDR] = store
        os.environ[env_util.HVD_COORDINATOR_SERVER] = "external"
    elif "coordinator_addr" in rec:  # a world of one needs no store
        os.environ.pop(env_util.HVD_COORDINATOR_ADDR, None)
    _record = rec
    _epoch = int(rec.get("epoch", 0))
    return new_rank


def _env_matches(rec: dict) -> bool:
    """Does this process's env already reflect ``rec``'s assignment?"""
    world = list(rec.get("world", ()))
    me = worker_id()
    if me not in world:
        return False
    ctrl = rec.get("controller_addr")
    store = rec.get("coordinator_addr")
    return (env_util.get_int(env_util.HVD_PROCESS_ID, 0) == world.index(me)
            and env_util.get_int(env_util.HVD_NUM_PROCESSES, 1) == len(world)
            and (not ctrl
                 or env_util.get_str(env_util.HVD_CONTROLLER_ADDR) == ctrl)
            and env_util.get_str(env_util.HVD_COORDINATOR_ADDR) == (
                store if "coordinator_addr" in rec else
                env_util.get_str(env_util.HVD_COORDINATOR_ADDR)))


def attach(timeout: float = 5.0) -> Optional[dict]:
    """Join the membership protocol at process start: read the committed
    epoch record, adopt it, and ack it (the driver's start barrier).
    When the world already moved between this worker's spawn and its
    attach (a shrink raced the interpreter start-up), the committed
    assignment is APPLIED — env rewritten, a stale heartbeat restarted —
    not merely acked; acking a world this process does not actually run
    in would satisfy the driver's stability barrier with a lie.  No-op
    outside elastic jobs; called by ``core.init()`` (before it reads the
    process identity) and by :func:`run`, idempotent."""
    global _epoch, _record
    if not enabled():
        return None
    try:
        rec = get_epoch_record(timeout=timeout)
    except (RuntimeError, urllib.error.URLError, OSError) as e:
        log.warning("membership attach failed: %s", e)
        return None
    if rec is None:
        return None
    if worker_id() not in rec.get("world", ()):
        # A spare (join_world announces later) or an evicted worker: no
        # ack for a roster we are not part of, and the epoch floor stays
        # one BEHIND the record — an evicted-at-startup worker must still
        # honor the abort flag stamped with the epoch it was removed
        # from, reach the seam, and die with RemovedFromWorldError
        # (adopting the new epoch would make its heartbeat discard that
        # flag as stale and leave a zombie training against a world it
        # left).
        _record = rec
        _epoch = max(int(rec.get("epoch", 0)) - 1, 0)
        return rec
    if not _env_matches(rec):
        log.warning("membership moved before attach: adopting epoch %s "
                    "assignment", rec.get("epoch"))
        _apply_env(rec)
        from . import heartbeat

        hb = heartbeat.instance()
        if hb is not None and hb.epoch != _epoch:
            heartbeat.stop()
            heartbeat.start_from_env()
    else:
        _record = rec
        _epoch = int(rec.get("epoch", 0))
    try:
        ack(_epoch)
    except (urllib.error.URLError, OSError) as e:
        log.warning("membership ack failed: %s", e)
    return rec


def apply_epoch(rec: dict) -> int:
    """Rebuild this process into the committed epoch ``rec``: re-assign
    the dense rank from the roster (:func:`_apply_env`), and
    re-initialize in process — ``core.reinit()`` releases every built
    step's graph, destroys the process group, joins the epoch's store,
    reconnects the controller client to the epoch's ``ControllerServer``
    and restarts the heartbeat under the new epoch;
    processes that never called ``core.init()`` (light harness workers)
    restart the heartbeat alone.  Returns the new rank."""
    new_rank = _apply_env(rec)
    from .. import core

    if core.is_initialized():
        core.reinit()
    else:
        from . import heartbeat

        heartbeat.stop()
        heartbeat.start_from_env()
    log.info("membership epoch %d applied: rank %d/%d (worker %s, "
             "controller %s)", _epoch, new_rank, len(rec.get("world", ())),
             worker_id(), rec.get("controller_addr") or "none")
    return new_rank


def renew_spare_lease() -> None:
    """Announce-keyed liveness for a worker the driver may be *holding*
    as a spare (``--min-np`` satisfied): one lease PUT at
    ``health/spare.<worker>`` — non-numeric key, so the driver's
    rank-lease expiry loop ignores it, but the server's STALE/DEAD
    verdicts apply and :meth:`~horovod_tpu_torch.elastic.driver.ElasticDriver.
    _purge_dead_spares` drops a dead-while-held spare before trying to
    admit it.  Best-effort: a failed renewal just ages the lease."""
    from ..run.http_client import put_kv
    from ..run.http_server import HEALTH_SCOPE, SPARE_PREFIX

    addr, port, secret = _wiring()
    interval = env_util.get_float(env_util.HVD_HEARTBEAT_INTERVAL_SECONDS,
                                  env_util.DEFAULT_HEARTBEAT_INTERVAL_SECONDS)
    body = json.dumps({"worker": worker_id(), "interval": interval,
                       "spare": True, "pid": os.getpid()}).encode()
    try:
        put_kv(addr, port, HEALTH_SCOPE, f"{SPARE_PREFIX}{worker_id()}",
               body, secret=secret)
    except (urllib.error.URLError, OSError) as e:
        log.debug("spare lease renewal failed: %s", e)


def clear_spare_lease() -> None:
    """Retire the spare lease on admission (the worker now renews a
    rank-keyed heartbeat lease instead)."""
    from ..run.http_client import delete_kv
    from ..run.http_server import HEALTH_SCOPE, SPARE_PREFIX

    addr, port, secret = _wiring()
    try:
        delete_kv(addr, port, HEALTH_SCOPE, f"{SPARE_PREFIX}{worker_id()}",
                  secret=secret)
    except (urllib.error.URLError, OSError):
        pass


def join_world(state: Any = None,
               timeout: Optional[float] = None) -> dict:
    """Spare-host entry: announce this worker at the rendezvous, wait for
    the driver to admit it into a committed epoch, rebuild into that
    epoch, and (when ``state`` is an ElasticState) receive the live
    training state from rank 0's in-memory broadcast.  Returns the epoch
    record; raises TimeoutError when no admitting epoch arrives.

    The wait is chunked at the heartbeat interval so the worker renews
    its **spare lease** (:func:`renew_spare_lease`) the whole time it
    may be sitting in ``driver.spares`` — a spare that dies while held
    stops renewing and is purged instead of being admitted into an
    epoch it can never ack."""
    timeout = elastic_timeout() if timeout is None else timeout
    announce()
    me = worker_id()
    deadline = time.monotonic() + timeout
    floor = -1
    interval = env_util.get_float(env_util.HVD_HEARTBEAT_INTERVAL_SECONDS,
                                  env_util.DEFAULT_HEARTBEAT_INTERVAL_SECONDS)
    while True:
        renew_spare_lease()
        rec = wait_for_epoch(
            floor + 1,
            timeout=min(interval, max(deadline - time.monotonic(), 0.0)))
        if rec is None:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"worker {me} announced itself but no epoch admitted "
                    f"it within {timeout:.0f}s (blocklisted, or the driver "
                    "is not elastic)"
                )
            continue  # chunk elapsed: renew the lease, keep waiting
        floor = int(rec.get("epoch", 0))
        if me in rec.get("world", ()):
            break
    clear_spare_lease()
    apply_epoch(rec)
    if state is not None and hasattr(state, "sync"):
        state.sync(int(rec["epoch"]))
    ack(int(rec["epoch"]))
    from . import peerstate

    peerstate.on_epoch(rec)  # re-register + reprotect (no-op when off)
    log.info("worker %s joined the world at epoch %s", me, rec.get("epoch"))
    return rec


def publish_state_blob(epoch: int, payload: dict) -> None:
    """Rank 0's half of the in-memory state broadcast (ElasticState.sync):
    one pickled ``{state, step}`` blob per epoch on the rendezvous."""
    from ..run.http_client import put_kv
    from ..run.http_server import MEMBERSHIP_SCOPE, STATE_PREFIX

    addr, port, secret = _wiring()
    put_kv(addr, port, MEMBERSHIP_SCOPE, f"{STATE_PREFIX}{int(epoch)}",
           pickle.dumps(payload), secret=secret, retry=True)


def fetch_state_blob(epoch: int,
                     timeout: Optional[float] = None) -> Optional[dict]:
    """The non-root half: wait for rank 0's broadcast of ``epoch`` (None
    on timeout — the caller falls back to checkpoint restore)."""
    from ..run.http_client import get_kv
    from ..run.http_server import MEMBERSHIP_SCOPE, STATE_PREFIX

    addr, port, secret = _wiring()
    timeout = elastic_timeout() if timeout is None else timeout
    raw = get_kv(addr, port, MEMBERSHIP_SCOPE, f"{STATE_PREFIX}{int(epoch)}",
                 secret=secret, wait=True, timeout=timeout)
    if raw is None:
        return None
    return pickle.loads(raw)


def check_fence() -> None:
    """Split-brain fence for rank-0-gated side effects (checkpoint
    writes): a partitioned rank that cannot reach the rendezvous — or
    whose epoch has been superseded — must not act as rank 0.  Raises
    :class:`HorovodAbortError`; no-op outside elastic jobs."""
    if not enabled():
        return
    try:
        rec = get_epoch_record()
    except (RuntimeError, urllib.error.URLError, OSError) as e:
        raise HorovodAbortError(
            f"fencing: rendezvous unreachable from worker {worker_id()} "
            f"({e}); refusing rank-0 side effects in a possible partition"
        )
    if rec is not None and int(rec.get("epoch", 0)) != _epoch:
        raise HorovodAbortError(
            f"fencing: membership moved to epoch {rec.get('epoch')} while "
            f"this worker is still in epoch {_epoch}; refusing rank-0 "
            "side effects"
        )


def run(fn: Callable, state: Any = None, *args: Any,
        on_world_change: Optional[Callable] = None, **kwargs: Any):
    """Execute ``fn(state, *args, **kwargs)`` under elastic supervision —
    the analog of ``@hvd.elastic.run`` (reference
    horovod/common/elastic.py run_fn).

    When a membership change interrupts training (the driver publishes
    the coordinated-abort flag and the next dispatch/step raises
    :class:`HorovodAbortError`), the wrapper waits for the new epoch,
    rebuilds in process (:func:`apply_epoch`), re-syncs ``state`` from
    rank 0's in-memory broadcast (when it is an
    :class:`~horovod_tpu_torch.elastic.state.ElasticState`), invokes
    ``on_world_change(state, old_size, new_size)`` — the batch/LR rescale
    hook — and calls ``fn`` again.  ``fn`` must therefore resume from
    ``state`` (e.g. iterate ``range(state.step, total_steps)``).

    A rank already inside a collective when its peer died does not reach
    the seam: the collective itself fails (gloo's connection to the dead
    rank closes; the port's collectives are ``torch.distributed``'s, not
    the reference's negotiated ones).  In an elastic job such an error is
    taken for the world change when the driver's abort flag reaches this
    process's heartbeat within two heartbeat intervals
    (:func:`_abort_follows`); otherwise it propagates.

    Outside elastic jobs, or when no new epoch is committed within
    ``HVD_ELASTIC_TIMEOUT_SECONDS`` (the job is actually dead), the
    original :class:`HorovodAbortError` propagates — fail-stop semantics
    are the fallback, not replaced.
    """
    attach()
    while True:
        try:
            return fn(state, *args, **kwargs)
        except RemovedFromWorldError:
            raise
        except Exception as e:
            if not enabled() or not (isinstance(e, HorovodAbortError)
                                     or _abort_follows(e)):
                raise
            log.warning("elastic: training interrupted (%s); waiting for "
                        "epoch >= %d", e, _epoch + 1)
            rec = wait_for_epoch(_epoch + 1)
            if rec is None:
                log.error("elastic: no new epoch within %.0fs; the job is "
                          "dead", elastic_timeout())
                raise
            old_size = world_size()
            apply_epoch(rec)  # raises RemovedFromWorldError when evicted
            old_step = getattr(state, "step", None)
            if state is not None and hasattr(state, "sync"):
                state.sync(int(rec["epoch"]))
            ack(int(rec["epoch"]))
            from . import peerstate

            # shrink re-replication: shards whose replicas left the
            # world are re-pushed at the epoch boundary (no-op when the
            # peer state plane is off)
            peerstate.on_epoch(rec)
            new_size = len(rec.get("world", ()))
            if on_world_change is not None:
                on_world_change(state, old_size, new_size)
            # flight recorder: the resume closes the incident chain the
            # epoch record carries across processes (observe/events.py)
            try:
                from ..observe import events as events_mod

                new_step = getattr(state, "step", None)
                steps_lost = max(int(old_step) - int(new_step), 0) \
                    if old_step is not None and new_step is not None \
                    else None
                events_mod.record_event(
                    "restart.resume", severity="info",
                    payload={"epoch": int(rec.get("epoch", 0)),
                             "old_size": old_size, "new_size": new_size,
                             "step": new_step, "steps_lost": steps_lost},
                    cause_id=rec.get("event_id"),
                    correlation_id=rec.get("correlation_id"),
                    rank=env_util.get_int(env_util.HVD_PROCESS_ID, 0))
            except Exception:  # noqa: BLE001 — recording is best-effort
                pass
            log.info("elastic: resuming in epoch %d (world %d -> %d)",
                     _epoch, old_size, new_size)


def _abort_follows(err: BaseException) -> bool:
    """Whether a collective's failure ``err`` is the world changing: the
    driver's abort flag reaches this process's heartbeat within two
    heartbeat intervals of it."""
    from . import heartbeat

    hb = heartbeat.instance()
    if hb is None:
        return False
    deadline = time.monotonic() + 2.0 * hb.interval + 0.5
    while hb.abort_info is None and time.monotonic() < deadline:
        time.sleep(0.02)
    if hb.abort_info is None:
        return False
    log.warning("elastic: a collective failed (%s: %s) as the world "
                "changed", type(err).__name__, err)
    return True


def _reset_for_tests() -> None:
    """Drop the module's epoch/identity state (test isolation)."""
    global _epoch, _record, _worker_id
    _epoch = 0
    _record = None
    _worker_id = None
