"""ElasticState: the auto-resume half of supervised restart — the port of
``horovod_tpu/elastic/state.py``.

The supervisor (``python -m horovod_tpu_torch.run --restarts N``)
relaunches a failed job with ``HVD_RESTART_COUNT`` exported; this module
is what the training script pairs with it so a relaunch *continues*
instead of starting over::

    state = htt.init_train_state(model, opt)
    es = htt.ElasticState("/ckpts/run1", state)
    state, start_step = es.resume()      # no-op on a fresh run
    for step in range(start_step, total_steps):
        state, loss = train_step(state, x, y)
        if (step + 1) % ckpt_every == 0:
            es.state = state
            es.save(step + 1)            # rank 0 writes step_{N}

A restore loads into the tensors of ``es.state`` in place
(``utils/checkpoint.load_into``), so a train step built on them before
``resume()`` keeps its captured graph.

On restart every rank restores the newest ``step_N`` checkpoint through
``utils/checkpoint.py`` (rank-consistent step choice + root-broadcast
restore), so the job loses at most one checkpoint interval — the
reference's broadcast-on-start resume contract (SURVEY §5), now driven
automatically by the failure-domain runtime.

With the peer state plane on (``HVD_SNAPSHOT=1``,
elastic/peerstate.py) the tiers invert: every ``save(step)`` becomes a
microsecond async snapshot to K peer hosts (one grouped device copy on
the step's stream, the rest in a background thread), the storage save is
demoted to every ``HVD_SNAPSHOT_STORAGE_EVERY``-th call as the durable
backstop, and ``resume()`` pulls from live peers first — checksum-
verified, falling back wholesale to the storage tier when peers are
dead or corrupt.  Either way the flight recorder logs which tier won
(``restore.source`` — docs/fault_tolerance.md#the-peer-state-plane).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .. import core
from ..utils import env as env_util
from ..utils.checkpoint import (
    latest_step, load_into, restore_checkpoint, save_checkpoint, to_numpy,
)
from ..utils.logging import get_logger

log = get_logger(__name__)


class ElasticState:
    """A checkpoint directory paired with the live training state."""

    def __init__(self, path: str, state: Any,
                 peer: Optional[bool] = None):
        self.path = path
        self.state = state
        self.step = 0
        self._saves = 0
        self._peer = None
        if peer is None:
            from . import peerstate

            peer = peerstate.enabled()
        if peer:
            from . import peerstate

            try:
                self._peer = peerstate.manager()
            except Exception as e:  # noqa: BLE001 — a broken peer tier
                # degrades to the storage-only contract, never to a
                # training job that cannot start
                log.warning("peer state plane unavailable (%s); falling "
                            "back to storage-tier checkpoints only", e)

    @property
    def restart_count(self) -> int:
        """Which incarnation this is (0 = first launch); set by the
        supervisor on every relaunch."""
        return env_util.get_int(env_util.HVD_RESTART_COUNT, 0)

    def save(self, step: int) -> Optional[str]:
        """Checkpoint the current state as ``step_{step}`` (rank 0 writes;
        returns the written path there, None elsewhere).

        Elastic jobs fence first: a partitioned ex-rank-0 that cannot
        reach the rendezvous — or whose membership epoch was superseded —
        must not keep writing checkpoints into the same directory as the
        re-assigned rank 0 (split-brain double-writer).

        Peer tier on: EVERY call is an async peer snapshot (µs of stall
        — the upload happens off the step path), and only every
        ``HVD_SNAPSHOT_STORAGE_EVERY``-th call still pays the
        synchronous storage save, the durable backstop."""
        if env_util.get_bool(env_util.HVD_ELASTIC) \
                and env_util.get_int(env_util.HVD_PROCESS_ID, 0) == 0:
            from . import membership

            membership.check_fence()
        out = None
        if self._peer is not None:
            self._peer.snapshot(self.state, step)
            every = max(env_util.get_int(
                env_util.HVD_SNAPSHOT_STORAGE_EVERY,
                env_util.DEFAULT_SNAPSHOT_STORAGE_EVERY), 1)
            if self._saves % every == 0:
                out = save_checkpoint(self.path, self.state, step=step)
        else:
            out = save_checkpoint(self.path, self.state, step=step)
        self._saves += 1
        self.step = int(step)
        return out

    def sync(self, epoch: Optional[int] = None) -> Tuple[Any, int]:
        """Re-sync the live state across a membership epoch — the
        shrink/grow path that loses ZERO committed steps: rank 0 (of the
        NEW dense assignment) broadcasts its in-memory ``{state, step}``
        through the rendezvous (its tensors as numpy arrays), everyone
        else (survivors and newcomers alike) loads it into its own
        tensors in place; no disk round trip.  Falls back to
        :meth:`resume` (checkpoint restore) when no broadcast arrives —
        e.g. a world where every member is new.  Returns
        ``(state, step)``."""
        from . import membership

        if epoch is None:
            epoch = membership.current_epoch()
        rank = env_util.get_int(env_util.HVD_PROCESS_ID, 0)
        if rank == 0:
            membership.publish_state_blob(
                epoch, {"state": to_numpy(self.state), "step": self.step})
            log.info("elastic sync: rank 0 broadcast step %d for epoch %d",
                     self.step, epoch)
            return self.state, self.step
        payload = membership.fetch_state_blob(epoch)
        if payload is None:
            log.warning("elastic sync: no rank-0 broadcast for epoch %d; "
                        "falling back to checkpoint restore", epoch)
            return self.resume()
        # into this rank's own tensors, in place: the model and a captured
        # step read those, not new ones
        self.state = load_into(self.state, payload["state"])
        self.step = int(payload["step"])
        log.info("elastic sync: adopted rank 0's step %d for epoch %d",
                 self.step, epoch)
        return self.state, self.step

    def resume(self) -> Tuple[Any, int]:
        """Restore the newest checkpoint and return ``(state, step)``;
        a fresh run returns the initial state and 0.

        Peer tier on: the newest fully-committed peer generation is
        tried first — shards pulled from live peers, checksum-verified
        (sub-second, no storage round trip) — and the storage tier is
        the wholesale fallback when no peer generation is restorable.
        Which tier won is recorded as a ``restore.source`` flight event
        chained onto the abort/epoch incident.

        Multi-process, BOTH tiers are collective decisions.  The peer
        path broadcasts rank 0's resolved generation so every rank
        targets the same snapshot, then all-gathers per-rank success
        before committing it — if ANY rank cannot restore that
        generation, every rank falls back wholesale to the storage
        tier (see :meth:`_restore_from_peers`).  The storage path
        broadcasts the step choice from rank 0 so every rank restores
        the same checkpoint even when only root can list the
        directory; the restore itself rides ``restore_checkpoint``'s
        agreement round (root failures surface on every rank)."""
        fallback_reason = None
        if self._peer is not None:
            got, fallback_reason = self._restore_from_peers()
            if got is not None:
                self.state, self.step = got[0], int(got[1])
                self._record_restore("peer", {"gen": self.step})
                try:
                    from ..observe import events as events_mod

                    events_mod.record_event(
                        "restart.resume", severity="info",
                        payload={"step": self.step, "source": "peer",
                                 "incarnation": self.restart_count},
                        rank=env_util.get_int(env_util.HVD_PROCESS_ID, 0))
                except Exception:  # noqa: BLE001
                    pass
                log.info("elastic resume: restored step %d from peers "
                         "(incarnation %d)", self.step, self.restart_count)
                return self.state, self.step
            log.warning("elastic resume: peer tier unrestorable (%s); "
                        "falling back to storage", fallback_reason)
        step = latest_step(self.path)
        if core.is_initialized() and core.process_size() > 1:
            from .. import eager

            step = eager.broadcast_object(step)
        if step is None:
            log.info("elastic resume: no checkpoint under %s (incarnation "
                     "%d starts fresh)", self.path, self.restart_count)
            self.step = 0
            return self.state, 0
        self.state = restore_checkpoint(self.path, self.state, step=step)
        self.step = int(step)
        if self._peer is not None:
            self._record_restore("storage", {"path": self.path,
                                             "reason": fallback_reason})
        try:
            from ..observe import events as events_mod

            events_mod.record_event(
                "restart.resume", severity="info",
                payload={"step": self.step,
                         "incarnation": self.restart_count,
                         "path": self.path},
                rank=env_util.get_int(env_util.HVD_PROCESS_ID, 0))
        except Exception:  # noqa: BLE001 — recording is best-effort
            pass
        log.info("elastic resume: restored step %d from %s (incarnation %d)",
                 self.step, self.path, self.restart_count)
        return self.state, self.step

    def _restore_from_peers(self) -> Tuple[Optional[Tuple[Any, int]],
                                           Optional[str]]:
        """Peer-tier restore with cross-rank agreement; returns
        ``(result, fallback_reason)``.

        Multi-process, the peer-vs-storage decision must be collective:
        rank 0's resolved generation is broadcast so every rank targets
        the SAME snapshot, and an agreement round (allgather of
        per-rank success) gates the result — if ANY rank cannot restore
        that generation (a transient manifest read, dead replicas, a
        corrupt shard), EVERY rank discards its peer result and the
        world falls back wholesale to the storage tier, whose step
        choice rank 0 already broadcasts.  Without the agreement round,
        one rank's private fallback to the storage checkpoint (step M)
        while the others restore a newer peer generation (step N > M)
        would silently diverge state/step across the world."""
        multi = core.is_initialized() and core.process_size() > 1
        gen = None
        if multi:
            from .. import eager

            if core.process_rank() == 0:
                try:
                    gen = self._peer.resolve_committed()
                except Exception as e:  # noqa: BLE001
                    self._peer.last_failure = f"{type(e).__name__}: {e}"
            gen = eager.broadcast_object(gen)
            if gen is None:
                return None, (self._peer.last_failure
                              or "no fully-committed generation")
        got = None
        try:
            got = self._peer.restore(self.state, gen=gen)
        except Exception as e:  # noqa: BLE001 — peer restore must
            # degrade to storage, never strand the relaunch
            self._peer.last_failure = f"{type(e).__name__}: {e}"
        if multi:
            from .. import eager

            oks = eager.allgather_object(got is not None)
            if not all(oks):
                bad = [r for r, ok in enumerate(oks) if not ok]
                reason = (self._peer.last_failure if got is None
                          else f"rank(s) {bad} could not restore peer "
                               f"gen {gen}")
                return None, reason or f"rank(s) {bad} failed peer restore"
        if got is None:
            return None, self._peer.last_failure or "peer tier empty"
        return got, None

    def _record_restore(self, source: str, extra: dict) -> None:
        """Emit ``restore.source`` (flight recorder) + the
        ``hvd_restores_total`` tick — chained onto the current epoch
        record's event ids so the restore shows up inside the
        abort→epoch incident it resolves (observe/events.py)."""
        from . import peerstate

        payload = {"source": source, "step": self.step,
                   "incarnation": self.restart_count}
        payload.update({k: v for k, v in extra.items() if v is not None})
        cause_id, correlation_id = peerstate._epoch_chain()
        try:
            from ..observe import events as events_mod

            events_mod.record_event(
                "restore.source", severity="info", payload=payload,
                cause_id=cause_id, correlation_id=correlation_id,
                rank=env_util.get_int(env_util.HVD_PROCESS_ID, 0))
        except Exception:  # noqa: BLE001
            pass
        try:
            from .. import metrics

            if metrics.on():
                metrics.RESTORES.labels(source).inc()
        except Exception:  # noqa: BLE001
            pass
