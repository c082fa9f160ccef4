"""Elastic driver: the launcher side of shrink/grow worlds — the port of
``horovod_tpu/elastic/driver.py``.

Owned by the launcher's ``--elastic`` supervisor (run/run.py) — the
analog of the reference's ElasticDriver + host discovery loop (reference
horovod/run/elastic/driver.py: worker state machine, host blacklisting,
rank re-assignment), re-based on the rendezvous server this repo already
runs for metrics/heartbeats:

* the driver **commits membership epochs** (elastic/membership.py wire
  layout) instead of killing the job on the first failure;
* worker death is detected two ways — child-process exit (the supervise
  loop polls every worker, whichever rank dies first) and **heartbeat
  lease expiry** on the server's own clock (which also catches network
  partitions: a ``kind=partition`` rank is alive but cannot renew);
* each epoch gets a **fresh ControllerServer** sized to the new world,
  so the native negotiation plane can never mix epochs, and (in the
  port) a **fresh** ``torch.distributed`` **TCPStore** for the new
  world's process group (``coordinator_addr`` in the record), so no key
  of the dead world can meet the new one;
* a worker removed ``HVD_ELASTIC_MAX_FLAPS`` times is **blocklisted**
  and its rejoin announcements are ignored (flapping hosts must not
  thrash the job with rebuild churn);
* rejoin announcements are admitted at the next epoch boundary, once
  the current epoch is stable (every member acked its rebuild).

The driver never relaunches processes itself — that remains
``--restarts``'s job, and the two compose: the driver shrinks past
failures while ``len(world) >= min_np``, and only when the floor is
violated does it give up, letting the restart loop do a full relaunch.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..run.http_server import (
    ABORT_KEY,
    ABORT_SCOPE,
    ANNOUNCE_PREFIX,
    BLOCKLIST_KEY,
    DRAIN_ACK_PREFIX,
    DRAIN_PREFIX,
    EPOCH_KEY,
    HEALTH_SCOPE,
    MEMBERSHIP_SCOPE,
    PREEMPT_PREFIX,
    READY_PREFIX,
    SPARE_PREFIX,
    STATE_PREFIX,
)
from ..utils import env as env_util
from ..utils.logging import get_logger
from .abort import make_flag

log = get_logger(__name__)


class ElasticDriver:
    """Membership authority for one job incarnation.

    ``rdv_server``: the launcher's RendezvousServer (direct in-process
    access — the driver is its single membership writer).
    ``worker_ids``: the initial roster, in rank order.
    ``controller``: "native" stands up a per-epoch ControllerServer and
    publishes its address in each epoch record; anything else leaves the
    eager plane controller-less (compiled-schedule-only jobs, tests).
    ``store_factory(size)``: makes the epoch's ``torch.distributed``
    store (served here, on a port it binds itself), whose
    ``controller_host:port`` the record carries as ``coordinator_addr``;
    None leaves the record without one (tests of the driver alone).
    """

    def __init__(self, rdv_server, worker_ids: Sequence[str], *,
                 min_np: int = 1, controller: str = "xla",
                 controller_host: str = "127.0.0.1",
                 max_flaps: Optional[int] = None,
                 drain_timeout: Optional[float] = None,
                 store_factory: Optional[Callable[[int], Any]] = None):
        self.server = rdv_server
        self.store_factory = store_factory
        #: the live epoch's store and the one before it (survivors may
        #: still be tearing down the dead world's group against it)
        self.stores: List[Any] = []
        self.coordinator_addr: Optional[str] = None
        self.min_np = max(int(min_np), 1)
        self.controller = controller
        self.controller_host = controller_host
        self.max_flaps = int(
            max_flaps if max_flaps is not None
            else env_util.get_int(env_util.HVD_ELASTIC_MAX_FLAPS,
                                  env_util.DEFAULT_ELASTIC_MAX_FLAPS))
        self.epoch = -1
        self.initial = set(str(w) for w in worker_ids)
        self.world: List[str] = []
        self.flaps: Dict[str, int] = {}
        self.blocklist: set = set()
        self.finished: set = set()   # members that exited 0 (end of training)
        self.failed_reason: Optional[str] = None  # set when below min_np
        self.ctrl_server = None
        self.controller_addr: Optional[str] = None
        self._commit_time = 0.0
        self._stable = False
        self._hb_interval = env_util.get_float(
            env_util.HVD_HEARTBEAT_INTERVAL_SECONDS,
            env_util.DEFAULT_HEARTBEAT_INTERVAL_SECONDS)
        self._timeout = env_util.get_float(
            env_util.HVD_ELASTIC_TIMEOUT_SECONDS,
            env_util.DEFAULT_ELASTIC_TIMEOUT_SECONDS)
        self._drain_timeout = float(
            drain_timeout if drain_timeout is not None
            else env_util.get_float(
                env_util.HVD_SERVE_DRAIN_TIMEOUT_SECONDS, self._timeout))
        # chaos-found liveness gap: a member that stops renewing right
        # before an unrelated commit clears the health scope never gets
        # a dead verdict (its lease entry is simply gone).  With the
        # grace > 0, a stable-epoch member with NO re-established lease
        # that long past stability is removed as dead.
        self._silent_grace = env_util.get_float(
            env_util.HVD_ELASTIC_SILENT_GRACE_SECONDS,
            env_util.DEFAULT_ELASTIC_SILENT_GRACE_SECONDS)
        self._stable_time = 0.0
        # serving-plane hooks (serving/autoscaler.py): an attached
        # autoscaler ticks from poll() on stable epochs, and announced
        # workers are HELD as spares for it instead of auto-admitted
        self.autoscaler = None
        self.hold_admissions = False
        self.spares: List[str] = []
        # called as on_remove(worker, drained) after every removal
        # commit: the serving plane hooks it to requeue a lossily-
        # removed replica's in-flight requests (broker.requeue)
        self.on_remove = None
        self.commit(list(worker_ids), reason="initial world")

    # -- flight recorder (observe/events.py) ---------------------------------
    def _event(self, kind: str, severity: str = "info",
               payload: Optional[dict] = None,
               cause_id: Optional[str] = None,
               rank: Optional[int] = None) -> Optional[str]:
        """Record one flight-recorder event; never raises (the recorder
        must not fail a membership change)."""
        try:
            from ..observe import events as events_mod

            return events_mod.record_event(kind, severity=severity,
                                           payload=payload,
                                           cause_id=cause_id, rank=rank)
        except Exception:  # noqa: BLE001
            return None

    # -- epoch commits -------------------------------------------------------
    def commit(self, world: List[str], *, removed: Sequence[str] = (),
               admitted: Sequence[str] = (), reason: str = "",
               cause_id: Optional[str] = None) -> dict:
        """Commit the next membership epoch: rebuild the per-epoch
        controller server, publish the record, and reset the stability
        barrier.  Single writer — only the driver calls this."""
        self.epoch += 1
        self.world = list(world)
        if self.controller == "native":
            old = self.ctrl_server
            from ..runtime.controller import ControllerServer

            self.ctrl_server = ControllerServer(len(world), port=0)
            self.controller_addr = (
                f"{self.controller_host}:{self.ctrl_server.port}")
            if old is not None:
                # survivors' clients reconnect during reinit; the dead
                # epoch's server holds half-negotiated state and must go
                old.stop()
        if self.store_factory is not None:
            # None for a world of one, which needs no store
            store = self.store_factory(len(world))
            self.stores = self.stores[-1:] + [store]
            self.coordinator_addr = None if store is None \
                else f"{self.controller_host}:{store.port}"
        rec = {
            "epoch": self.epoch,
            "world": self.world,
            "size": len(self.world),
            "removed": list(removed),
            "admitted": list(admitted),
            "controller_addr": self.controller_addr,
            "reason": reason,
            "time": time.time(),
        }
        if self.store_factory is not None:
            rec["coordinator_addr"] = self.coordinator_addr
        # the commit event rides the epoch record itself, so workers
        # that observe the new epoch can chain their restart/resume
        # events onto it across processes
        eid = self._event(
            "epoch.commit",
            severity="warning" if (removed or admitted) else "info",
            payload={"epoch": self.epoch, "size": len(self.world),
                     "removed": list(removed), "admitted": list(admitted),
                     "reason": reason},
            cause_id=cause_id)
        if eid:
            rec["event_id"] = eid
            try:
                from ..observe import events as events_mod

                corr = events_mod.correlation_of(eid)
                if corr:
                    rec["correlation_id"] = corr
            except Exception:  # noqa: BLE001
                pass
        # health first: stale leases keyed by the OLD ranks must not read
        # as deaths in the new epoch (new heartbeats re-populate on ack)
        self.server.clear_scope(HEALTH_SCOPE)
        self.server.put(MEMBERSHIP_SCOPE, EPOCH_KEY,
                        json.dumps(rec).encode())
        self.server.put(MEMBERSHIP_SCOPE, BLOCKLIST_KEY,
                        json.dumps(sorted(self.blocklist)).encode())
        self._commit_time = time.monotonic()
        self._stable = False
        from .. import metrics

        if metrics.on():
            metrics.MEMBERSHIP_EPOCHS.inc()
            if removed:
                metrics.RANKS_REMOVED.inc(len(removed))
            if admitted:
                metrics.RANKS_ADMITTED.inc(len(admitted))
        log.warning("membership epoch %d committed: world=%s removed=%s "
                    "admitted=%s (%s)", self.epoch, self.world,
                    list(removed), list(admitted), reason)
        return rec

    # -- membership changes --------------------------------------------------
    def remove(self, worker: str, reason: str, *,
               drain: bool = False,
               cause_id: Optional[str] = None) -> bool:
        """Shrink the world past ``worker``.  Workers that already
        finished cleanly are drained from the roster in the same commit
        (they will never ack or heartbeat again — leaving them in would
        hang the stability barrier and hand rank 0 to an exited
        process).  Returns False (and records ``failed_reason``) when
        the LIVE remainder would violate ``min_np`` — the caller must
        then fail the job the fail-stop way.

        ``drain=True`` is the **lossless** scale-down path (serving
        autoscaler, planned maintenance): before anything is revoked or
        committed, the departing worker is asked to stop pulling new
        work, finish what it has in flight, and ack — the drain
        handshake (``drain.<worker>`` → ``drain_ack.<worker>`` under
        the membership scope).  Only after the ack (or the
        ``HVD_SERVE_DRAIN_TIMEOUT_SECONDS`` budget, in which case the
        removal degrades to the lossy path with a warning) is the
        shrink epoch committed, so a drained shrink loses zero
        requests/steps.  Voluntary drains do not count toward the
        flapping blocklist — a worker scaled down N times is not a
        flaky host."""
        if worker not in self.world:
            return True
        finished = [w for w in self.world
                    if w != worker and w in self.finished]
        survivors = [w for w in self.world
                     if w != worker and w not in self.finished]
        if len(survivors) < self.min_np:
            self.failed_reason = (
                f"{reason}; world would shrink to {len(survivors)} < "
                f"min_np {self.min_np}")
            return False
        old_rank = self.world.index(worker)
        remove_eid = self._event(
            "epoch.remove", severity="warning",
            payload={"worker": worker, "rank": old_rank, "reason": reason,
                     "drain": bool(drain)},
            cause_id=cause_id, rank=old_rank)
        drained_ok = False
        if drain:
            drained_ok = self._drain(worker, cause_id=remove_eid)
            if not drained_ok:
                log.warning(
                    "drain handshake with worker %s timed out after "
                    "%.1fs; removing it the lossy way", worker,
                    self._drain_timeout)
        if not drain:
            self.flaps[worker] = self.flaps.get(worker, 0) + 1
            if self.flaps[worker] >= self.max_flaps:
                self.blocklist.add(worker)
                self._event("epoch.blocklist", severity="critical",
                            payload={"worker": worker,
                                     "flaps": self.flaps[worker]},
                            cause_id=remove_eid)
                log.warning("worker %s blocklisted after %d removals",
                            worker, self.flaps[worker])
        # the lease itself is revoked by commit()'s HEALTH-scope reset
        self._publish_abort(reason, rank=old_rank, cause_id=remove_eid)
        if finished:
            reason = f"{reason} (drained finished worker(s) {finished})"
        if drained_ok:
            reason = f"{reason} (drained: in-flight work completed)"
        self.commit(survivors, removed=[worker], reason=reason,
                    cause_id=remove_eid)
        if self.on_remove is not None:
            try:
                self.on_remove(worker, drained_ok)
            except Exception:  # noqa: BLE001 — a hook bug must not
                log.exception("on_remove hook failed for worker %s",
                              worker)  # fail the membership change
        return True

    def _drain(self, worker: str,
               cause_id: Optional[str] = None) -> bool:
        """Run the drain handshake with ``worker``: publish the request
        key, wait for the ack, clean both keys up.  True iff the worker
        acked inside the budget.

        The wait is synchronous — supervision (lease expiry, child-exit
        reaping) pauses for up to ``HVD_SERVE_DRAIN_TIMEOUT_SECONDS``
        while a drain is in flight.  Drains are rare, operator/
        autoscaler-paced events; tune the budget down if concurrent
        failure reaction matters more than drain patience."""
        req_key = f"{DRAIN_PREFIX}{worker}"
        ack_key = f"{DRAIN_ACK_PREFIX}{worker}"
        drain_eid = self._event("epoch.drain",
                                payload={"worker": worker,
                                         "epoch": self.epoch,
                                         "timeout": self._drain_timeout},
                                cause_id=cause_id)
        # a stale ack from a previous timed-out handshake (acked just
        # past the deadline) must not read as an instant lossless drain
        self.server.delete(MEMBERSHIP_SCOPE, ack_key)
        self.server.put(MEMBERSHIP_SCOPE, req_key, json.dumps({
            "worker": worker, "epoch": self.epoch, "time": time.time(),
        }).encode())
        deadline = time.monotonic() + self._drain_timeout
        acked = False
        while time.monotonic() < deadline:
            if self.server.get(MEMBERSHIP_SCOPE, ack_key) is not None:
                acked = True
                break
            time.sleep(0.02)
        self.server.delete(MEMBERSHIP_SCOPE, req_key)
        self.server.delete(MEMBERSHIP_SCOPE, ack_key)
        self._event("epoch.drain_ack",
                    severity="info" if acked else "warning",
                    payload={"worker": worker, "acked": acked},
                    cause_id=drain_eid)
        if acked:
            from .. import metrics

            if metrics.on():
                metrics.SERVE_DRAINS.inc()
        return acked

    def admit(self, workers: Sequence[str],
              reason: str = "rejoin",
              cause_id: Optional[str] = None) -> Optional[dict]:
        """Grow the world by ``workers`` at this epoch boundary (the
        running members are interrupted through the same abort seam a
        shrink uses — rejoin is the shrink path in reverse)."""
        workers = [w for w in workers
                   if w not in self.blocklist and w not in self.world]
        if not workers:
            return None
        admit_eid = self._event("epoch.admit",
                                payload={"workers": list(workers),
                                         "epoch": self.epoch + 1,
                                         "reason": reason},
                                cause_id=cause_id)
        self._publish_abort(
            f"admitting worker(s) {workers} into epoch {self.epoch + 1}",
            rank=None, cause_id=admit_eid)
        return self.commit(self.world + list(workers), admitted=workers,
                           reason=reason, cause_id=admit_eid)

    def preempt(self, worker: str, grace: Optional[float] = None,
                cause_id: Optional[str] = None) -> bool:
        """Handle a preemption notice for ``worker`` (cloud maintenance
        signal, ``kind=preempt`` fault) as a **planned drain+snapshot**,
        not a crash: the worker is asked to finish in flight, snapshot,
        and ack inside the ``grace`` window (capped at the drain
        budget); only then is the shrink committed.  Voluntary, so it
        never counts toward the flapping blocklist.  Returns False when
        the shrink would violate ``min_np`` (same contract as
        :meth:`remove`)."""
        if worker not in self.world or worker in self.finished:
            return True
        eid = self._event(
            "preempt.notice", severity="warning",
            payload={"worker": worker, "grace": grace,
                     "epoch": self.epoch},
            cause_id=cause_id, rank=self.world.index(worker))
        old = self._drain_timeout
        if grace:
            self._drain_timeout = min(old, float(grace))
        try:
            return self.remove(
                worker,
                f"preemption notice for worker {worker} "
                f"(grace {self._drain_timeout:.1f}s)",
                drain=True, cause_id=eid)
        finally:
            self._drain_timeout = old

    # -- serving-plane hooks (serving/autoscaler.py) -------------------------
    def attach_autoscaler(self, autoscaler, *,
                          hold_admissions: bool = True) -> None:
        """Give load, not failures, control of the world: ``autoscaler
        .tick()`` runs from every stable-epoch poll, and (by default)
        announced workers are held in ``self.spares`` for it to admit
        instead of being auto-admitted at the next boundary."""
        self.autoscaler = autoscaler
        self.hold_admissions = hold_admissions

    def admit_spare(self, reason: str = "autoscale grow"
                    ) -> Optional[str]:
        """Admit the longest-held spare (FIFO) into the next epoch;
        returns its worker id, or None when no spare is available.

        Held spares DO carry a liveness signal: ``join_world`` renews an
        announce-keyed lease at ``health/spare.<worker>`` the whole time
        the worker waits, and :meth:`_purge_dead_spares` runs before
        each admission attempt — a spare that died while held is purged
        here (and from the stable-epoch poll) instead of being admitted,
        stalling the stability barrier for an elastic timeout, and only
        then being removed by rank-lease expiry."""
        self._purge_dead_spares()
        while self.spares:
            w = self.spares.pop(0)
            if w in self.blocklist or w in self.world:
                continue
            if self.admit([w], reason=reason) is not None:
                return w
        return None

    def _purge_dead_spares(self) -> None:
        """Drop held spares whose ``spare.<worker>`` lease went dead
        (elastic/membership.renew_spare_lease).  A spare with NO lease
        entry is left alone — its key may simply have been wiped by the
        last epoch commit's health-scope clear and not yet re-renewed;
        the dead verdict is the only affirmative death signal."""
        if not self.spares:
            return
        ranks = self.server.health_report().get("ranks", {})
        for w in list(self.spares):
            info = ranks.get(f"{SPARE_PREFIX}{w}")
            if info is None or info.get("verdict") != "dead":
                continue
            self.spares.remove(w)
            self.server.delete(HEALTH_SCOPE, f"{SPARE_PREFIX}{w}")
            self._event("spare.purged", severity="warning",
                        payload={"worker": w,
                                 "age_seconds": info.get("age_seconds"),
                                 "held": len(self.spares)})
            log.warning("purged dead spare %s (lease age %.1fs); %d "
                        "spare(s) still held", w,
                        info.get("age_seconds") or -1.0, len(self.spares))

    def _publish_abort(self, reason: str, rank: Optional[int],
                       cause_id: Optional[str] = None) -> None:
        """Stamp the flag with the epoch being aborted so survivors that
        already rebuilt ignore it (elastic/heartbeat.py epoch filter)."""
        flag = make_flag(reason, rank=rank, source="elastic_driver",
                         epoch=self.epoch)
        eid = self._event("abort.publish", severity="critical",
                          payload={"reason": reason, "epoch": self.epoch,
                                   "source": "elastic_driver"},
                          cause_id=cause_id, rank=rank)
        if eid:
            flag["event_id"] = eid
            try:
                from ..observe import events as events_mod

                corr = events_mod.correlation_of(eid)
                if corr:
                    flag["correlation_id"] = corr
            except Exception:  # noqa: BLE001
                pass
        self.server.put(ABORT_SCOPE, ABORT_KEY, json.dumps(flag).encode())

    # -- the periodic poll ---------------------------------------------------
    def _ready_workers(self, epoch: int) -> set:
        prefix = f"{READY_PREFIX}{epoch}."
        return {k[len(prefix):]
                for k in self.server.scope_items(MEMBERSHIP_SCOPE)
                if k.startswith(prefix)}

    def _announced(self) -> set:
        return {k[len(ANNOUNCE_PREFIX):]
                for k in self.server.scope_items(MEMBERSHIP_SCOPE)
                if k.startswith(ANNOUNCE_PREFIX)}

    def _gc(self) -> None:
        """Drop rebuild artifacts of finished epochs (state blobs and
        ready acks below the current epoch) so a long-lived job's store
        stays bounded."""
        for key in list(self.server.scope_items(MEMBERSHIP_SCOPE)):
            for prefix in (STATE_PREFIX, READY_PREFIX):
                if key.startswith(prefix):
                    epoch_s = key[len(prefix):].split(".", 1)[0]
                    if epoch_s.isdigit() and int(epoch_s) < self.epoch:
                        self.server.delete(MEMBERSHIP_SCOPE, key)

    def poll(self) -> None:
        """One supervision tick: advance the stability barrier, remove
        lease-dead members, admit pending announcements."""
        now = time.monotonic()
        if not self._stable:
            acked = self._ready_workers(self.epoch)
            if set(self.world) <= acked:
                self._stable = True
            elif now - self._commit_time > self._timeout:
                log.warning(
                    "epoch %d stability timeout: %s never acked; "
                    "proceeding without the barrier", self.epoch,
                    sorted(set(self.world) - acked))
                self._stable = True
            if self._stable:
                # the aborted epoch is fully drained: the flag and the
                # old rebuild artifacts can go
                self._stable_time = now
                self.server.clear_scope(ABORT_SCOPE)
                self._gc()
        # lease expiry (partitions, silent deaths of external members):
        # enforced only on a STABLE epoch — mid-rebuild, a survivor may
        # legitimately be silent for a whole step/save between observing
        # the abort and restarting its heartbeat, and that silence must
        # not read as a second failure
        if self._stable and now - self._commit_time > 2.0 * self._hb_interval:
            report = self.server.health_report()
            # rank keys in the report refer to THIS roster; a mid-loop
            # remove() re-assigns ranks densely, so indexing self.world
            # with later keys would name the wrong (live) worker
            roster = list(self.world)
            for rank_s, info in report.get("ranks", {}).items():
                if info.get("verdict") != "dead":
                    continue
                if not rank_s.isdigit() or int(rank_s) >= len(roster):
                    continue  # a stale key from a previous epoch
                worker = roster[int(rank_s)]
                if worker in self.finished or worker not in self.world:
                    continue  # exited 0 / already removed this pass
                lease_eid = self._event(
                    "lease.expired", severity="critical",
                    payload={"rank": int(rank_s), "worker": worker,
                             "age_seconds": info.get("age_seconds"),
                             "interval": info.get("interval")},
                    rank=int(rank_s))
                self.remove(worker, f"rank {rank_s} (worker {worker}) "
                            "heartbeat lease expired",
                            cause_id=lease_eid)
            # the silent-member sweep: a lease entry wiped by a commit's
            # health-scope clear and never re-established leaves a dead
            # member with NO verdict at all — after the (opt-in) grace
            # past stability, missing reads as dead too
            if self._silent_grace > 0 and self._stable \
                    and now - self._stable_time > self._silent_grace:
                ranks = report.get("ranks", {})
                for i, worker in enumerate(roster):
                    if not self._stable:
                        break  # a removal above re-opened the epoch
                    if str(i) in ranks or worker not in self.world \
                            or worker in self.finished:
                        continue
                    eid = self._event(
                        "lease.expired", severity="critical",
                        payload={"rank": i, "worker": worker,
                                 "silent": True,
                                 "grace": self._silent_grace},
                        rank=i)
                    self.remove(
                        worker, f"rank {i} (worker {worker}) never "
                        "re-established its heartbeat lease",
                        cause_id=eid)
        if self._stable:
            # pending preemption notices become planned drains at the
            # next stable boundary (mid-rebuild, the key just waits)
            items = self.server.scope_items(MEMBERSHIP_SCOPE)
            for key in sorted(items):
                if not key.startswith(PREEMPT_PREFIX):
                    continue
                if not self._stable:
                    break  # an earlier preempt re-opened the epoch
                worker = key[len(PREEMPT_PREFIX):]
                grace = None
                try:
                    grace = json.loads(items[key]).get("grace")
                except (ValueError, TypeError):
                    pass
                self.server.delete(MEMBERSHIP_SCOPE, key)
                self.preempt(worker, grace=grace)
        if self._stable and self.failed_reason is None \
                and not self.finished:
            # no admissions once any member finished: the job is winding
            # down, and a joiner would inherit a roster of exiting peers
            self._purge_dead_spares()
            announced = self._announced()
            for w in sorted(announced & self.blocklist):
                # a blocklisted flapper's announce can never be admitted;
                # leaving the key would read as a forever-pending rejoin
                self.server.delete(MEMBERSHIP_SCOPE, f"{ANNOUNCE_PREFIX}{w}")
            pending = sorted(announced - set(self.world) - self.blocklist)
            if pending:
                for w in pending:
                    self.server.delete(MEMBERSHIP_SCOPE,
                                       f"{ANNOUNCE_PREFIX}{w}")
                if self.hold_admissions:
                    # serving mode: spares are capacity-in-reserve for
                    # the autoscaler, not immediate members
                    self.spares.extend(w for w in pending
                                       if w not in self.spares)
                    log.info("holding announced worker(s) %s as spares "
                             "(%d held)", pending, len(self.spares))
                else:
                    self.admit(pending)
            if self.autoscaler is not None:
                try:
                    self.autoscaler.tick()
                except Exception:  # noqa: BLE001 — a policy bug must
                    log.exception(   # not take down supervision
                        "serving autoscaler tick failed")

    # -- supervision ---------------------------------------------------------
    def supervise(self, job, poll_interval: float = 0.2) -> int:
        """Drive the job to completion: ``job.procs[i]`` is the child of
        initial worker ``str(i)``.  Child failures shrink the world (or
        fail the job below ``min_np``); externally admitted workers are
        tracked through their leases only.  Returns 0 when every worker
        still in the world exited cleanly."""
        procs = job.procs
        handled: set = set()
        while True:
            self.poll()
            states = [p.poll() for p in procs]
            for wid, code in enumerate(states):
                w = str(wid)
                if code is None or w in handled:
                    continue
                handled.add(w)
                if code == 0:
                    if w in self.world:
                        # a MEMBER exiting 0 means end of training: the
                        # job is winding down (admissions pause)
                        self.finished.add(w)
                    else:
                        # a worker the autoscaler drained out of the
                        # world exits 0 as the normal end of its
                        # removal — that must NOT read as the job
                        # winding down, or the first serving scale-
                        # down would freeze autoscaling forever
                        log.info("removed worker %s exited cleanly", w)
                    continue
                if w in self.world:
                    if not self.remove(
                            w, f"worker {w} exited with code {code}"):
                        log.error("elastic give-up: %s", self.failed_reason)
                        self._publish_giveup(self.failed_reason)
                        job.kill_all()
                        return code
                else:
                    log.info("already-removed worker %s exited with code "
                             "%d", w, code)
            if self.failed_reason is not None:
                # a lease-expiry removal inside poll() hit the min_np
                # floor: fail the job the fail-stop way
                log.error("elastic give-up: %s", self.failed_reason)
                self._publish_giveup(self.failed_reason)
                job.kill_all()
                return 1
            if all(c is not None for c in states):
                bad = [c for wid, c in enumerate(states)
                       if str(wid) in self.world and c != 0]
                if not bad:
                    self._drain_external()
                return bad[0] if bad else 0
            time.sleep(poll_interval)

    def _drain_external(self) -> None:
        """Externally admitted joiners have no child process to wait on;
        give them up to the elastic timeout to finish (their heartbeat
        lease going dead is the exit signal) before the launcher tears
        the rendezvous down from under them.  Their exit codes cannot be
        observed — a joiner's failure does not change the job result."""
        external = set(self.world) - self.initial - self.finished
        if not external:
            return
        log.info("waiting up to %.0fs for externally admitted worker(s) "
                 "%s to finish", self._timeout, sorted(external))
        deadline = time.monotonic() + self._timeout
        while time.monotonic() < deadline:
            report = self.server.health_report()
            live = set()
            for w in external:
                if w not in self.world:
                    continue
                info = report.get("ranks", {}).get(
                    str(self.world.index(w)))
                if info is not None and info.get("verdict") != "dead":
                    live.add(w)
            if not live:
                return
            time.sleep(0.5)
        log.warning("externally admitted worker(s) still live at "
                    "teardown: %s", sorted(external))

    def _publish_giveup(self, reason: Optional[str]) -> None:
        """An epoch-less abort flag: honored by EVERY epoch, so all
        survivors (including external joiners) stop."""
        flag = make_flag(reason or "elastic driver gave up", rank=None,
                         source="elastic_driver")
        eid = self._event("epoch.giveup", severity="critical",
                          payload={"reason": reason,
                                   "min_np": self.min_np,
                                   "epoch": self.epoch})
        if eid:
            flag["event_id"] = eid
            try:
                from ..observe import events as events_mod

                corr = events_mod.correlation_of(eid)
                if corr:
                    flag["correlation_id"] = corr
            except Exception:  # noqa: BLE001
                pass
            # the launcher's restart loop chains restart.attempt onto
            # the give-up that triggered the relaunch (run/run.py)
            self.last_giveup_event_id = eid
        self.server.put(ABORT_SCOPE, ABORT_KEY, json.dumps(flag).encode())

    def shutdown(self) -> None:
        if self.ctrl_server is not None:
            self.ctrl_server.stop()
            self.ctrl_server = None
        self.stores = []  # a TCPStore's server stops with its object
