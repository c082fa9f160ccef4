"""Peer-replicated state plane: async snapshots + restore-from-peers —
the port of ``horovod_tpu/elastic/peerstate.py``.

Every recovery without this module funnels through the synchronous
storage path in utils/checkpoint.py — correct, but at large worlds the
cold-storage round trip is the availability bottleneck.  This module
layers a **peer checkpoint tier** over that storage path so a failure
costs one async snapshot interval, not a storage restore:

* **Asynchronous snapshot** — ``snapshot(state, step)`` is the step-path
  call.  The reference parks a *reference* to its immutable arrays; the
  port's train step updates its tensors in place (and a graph replay
  overwrites them), so a reference would read later values.  Instead
  ``snapshot`` copies every tensor of the state, on the current (the
  step's) stream, into a persistent snapshot buffer — one grouped
  ``torch._foreach_copy_``, the device's bandwidth, µs of host time — and
  parks that buffer in a depth-one latest-wins slot.  A daemon thread
  waits for the copy, copies the buffer to pinned host memory on a side
  stream (off the step's stream), turns the leaves into numpy arrays and
  does the pickle + sharding + CRC32 content checksums + peer upload.
  Two buffer sets alternate, so a snapshot never overwrites the set the
  thread is still reading.  Leaves travel as numpy arrays, so a float32
  snapshot from either package restores in the other; a bfloat16 leaf
  travels as float32, which holds it exactly, and is cast back on
  restore (``utils/checkpoint.to_numpy`` / ``load_into``).  The storage
  save is demoted to a slower cadence (``HVD_SNAPSHOT_STORAGE_EVERY``) as
  the durable backstop — elastic/state.py owns that demotion.
* **K-peer replication** — each rank's shards are pushed to
  ``HVD_PEER_REPLICAS`` peer *hosts* (prefer cross-host: placement rides
  the host labels the relay tree publishes).  Every worker runs a small
  shard server (a plain :class:`~horovod_tpu_torch.run.http_server.
  RendezvousServer` — same HMAC surface, same retrying client) and
  registers its endpoint under ``peerstate/addr.<worker>`` on the
  central rendezvous.
* **Generations + commit markers** — a snapshot generation is its step
  number.  Each rank writes ``manifest.<gen>.<rank>`` (shard sizes,
  checksums, replica placement) and then — only after every shard is
  pushed — the commit marker ``commit.<gen>.<rank>``.  Both live in the
  journaled ``peerstate`` scope, the same keys and bytes as the
  reference's.  A generation is
  restorable iff every rank of its world committed; GC **clears the
  commit marker first**, then deletes shards — the cleared-before-
  overwrite invariant, kept on the peer tier.
* **Restore-from-peers** — :meth:`PeerSnapshotManager.restore` resolves
  the newest fully-committed generation, pulls this rank's shards from
  live peers over HTTP (retry/backoff from run/http_client), verifies
  checksums, loads the values into the caller's tensors in place, and
  returns ``None`` when any shard is unrecoverable —
  the caller (ElasticState.resume) then falls back wholesale to the
  storage tier.  Fault seams: ``kind=corrupt`` at ``seam=peer_push``
  flips shard bytes in flight; ``seam=peer_pull`` models a peer dying
  mid-restore (elastic/faults.py).
* **Elastic redistribution** — a joining rank pulls its shards from
  peers through the same restore path (no file listing), and
  :meth:`reprotect` re-pushes shards whose replicas left the world so
  K-redundancy is restored at the next stable epoch
  (membership epoch hooks call :func:`on_epoch`).

Flight recorder: ``snapshot.begin`` / ``snapshot.commit`` and
``restore.source`` (payload ``source=peer|storage``) chain onto the
abort/epoch chain via the epoch record's embedded event ids.  Metrics:
the ``hvd_snapshot_*`` family.  Knobs: ``HVD_SNAPSHOT`` /
``HVD_SNAPSHOT_SHARDS`` / ``HVD_SNAPSHOT_KEEP`` /
``HVD_SNAPSHOT_STORAGE_EVERY`` / ``HVD_SNAPSHOT_TIMEOUT_SECONDS`` /
``HVD_SNAPSHOT_COPY`` / ``HVD_PEER_REPLICAS``
(docs/fault_tolerance.md#the-peer-state-plane).
"""

from __future__ import annotations

import json
import pickle
import socket
import threading
import time
import urllib.error
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils import env as env_util
from ..utils.checkpoint import load_into, to_numpy
from ..utils.logging import get_logger
from . import faults

log = get_logger(__name__)

#: shard keys on a peer's shard server: ``<gen>.<src_rank>.<idx>``
SHARD_SCOPE = "shard"


def enabled() -> bool:
    """True when the peer tier is on (``HVD_SNAPSHOT=1``) and at least
    one replica is asked for."""
    return env_util.get_bool(env_util.HVD_SNAPSHOT) and replicas() > 0


def replicas() -> int:
    return env_util.get_int(env_util.HVD_PEER_REPLICAS,
                            env_util.DEFAULT_PEER_REPLICAS)


def checksum(data: bytes) -> str:
    """Content checksum of one shard (CRC32 — integrity against torn or
    bit-flipped transfers, not an adversary; the HMAC transport covers
    tampering)."""
    return f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def shard_payload(payload: bytes, nshards: int) -> List[bytes]:
    """Split one serialized state blob into ``nshards`` contiguous
    pieces (the last carries the remainder; tiny states yield fewer,
    never empty, shards)."""
    nshards = max(int(nshards), 1)
    if not payload:
        return [b""]
    size = max((len(payload) + nshards - 1) // nshards, 1)
    return [payload[i:i + size] for i in range(0, len(payload), size)]


class _Leaf:
    """Where the ``index``-th tensor of a parked snapshot goes back in."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _detach(state: Any, copy_arrays: bool,
            tensors: Optional[List[torch.Tensor]] = None) -> Any:
    """Detach an enqueued snapshot from later caller mutation.

    Containers (dict / list / tuple / namedtuple) are rebuilt, so an
    in-place container update (``state["step"] = ...``) between the
    enqueue and the background serialize cannot tear the parked
    snapshot or advance it past its generation label.  Tensor leaves are
    appended to ``tensors`` and replaced by a :class:`_Leaf` (the
    caller copies them into its snapshot buffer: the port's tensors are
    updated in place); other leaves are shared.  ``copy_arrays``
    (``HVD_SNAPSHOT_COPY=1``) additionally copies numpy ndarray leaves —
    a bounded host memcpy per enqueue — for loops that mutate them."""
    if isinstance(state, dict):
        return {k: _detach(v, copy_arrays, tensors)
                for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        vals = [_detach(v, copy_arrays, tensors) for v in state]
        if isinstance(state, list):
            return vals
        if hasattr(state, "_fields"):  # namedtuple
            return type(state)(*vals)
        return tuple(vals)
    if torch.is_tensor(state) and tensors is not None:
        tensors.append(state.detach())
        return _Leaf(len(tensors) - 1)
    if copy_arrays:
        try:
            import numpy as np

            if isinstance(state, np.ndarray):
                return np.array(state, copy=True)
        except Exception:  # noqa: BLE001 — a leaf that cannot be
            pass           # copied is shared, same as the default
    return state


def _refill(skeleton: Any, leaves: List[Any]) -> Any:
    """``skeleton`` with each :class:`_Leaf` replaced by its value."""
    if isinstance(skeleton, _Leaf):
        return leaves[skeleton.index]
    if isinstance(skeleton, dict):
        return {k: _refill(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        vals = [_refill(v, leaves) for v in skeleton]
        if isinstance(skeleton, list):
            return vals
        if hasattr(skeleton, "_fields"):
            return type(skeleton)(*vals)
        return tuple(vals)
    return skeleton


class _Buffers:
    """One snapshot buffer set: a tensor like each of the state's tensor
    leaves (on its device, with its strides, so the grouped copy takes
    ``_foreach_copy_``'s fast path), and for device tensors a pinned host
    mirror with the same strides the background thread copies into."""

    def __init__(self, like: List[torch.Tensor]):
        self.sig = _signature(like)
        self.dev = [torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                                        device=t.device) for t in like]
        self.host = [torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                                         pin_memory=True)
                     if t.is_cuda else d for t, d in zip(like, self.dev)]


def _signature(tensors: List[torch.Tensor]) -> list:
    return [(t.shape, t.stride(), t.dtype, t.device) for t in tensors]


def choose_peers(me: str, addrs: Dict[str, dict], k: int,
                 local_size: Optional[int] = None) -> List[str]:
    """Pick ``k`` replica holders for ``me`` from the registered shard
    servers, topology-aware: cross-host peers first (a host loss must
    not take a shard and all its replicas), ring-offset within each
    preference class so placement is deterministic and spread.  When
    host labels cannot separate workers (single-host tests, or a
    ``local_size`` covering the world — one ICI domain, everything is
    the same DCN tier per ``TopologySpec``), any peer qualifies."""
    workers = sorted(w for w in addrs if w != me)
    if not workers or k <= 0:
        return []
    my_host = (addrs.get(me) or {}).get("host")
    ordered = sorted(addrs)
    base = ordered.index(me) if me in ordered else 0
    # ring order starting just past me, so consecutive ranks spread
    # their replicas instead of all hammering worker 0
    ring = sorted(workers,
                  key=lambda w: (ordered.index(w) - base) % len(ordered))
    ls = local_size if local_size is not None else env_util.get_int(
        env_util.HVD_LOCAL_SIZE, 1)
    one_domain = ls >= len(addrs)  # whole world shares one ICI domain
    cross = [w for w in ring
             if one_domain or my_host is None
             or (addrs.get(w) or {}).get("host") != my_host]
    same = [w for w in ring if w not in cross]
    return (cross + same)[:min(k, len(workers))]


def _flight_event(kind: str, payload: dict, severity: str = "info",
                  cause_id: Optional[str] = None,
                  correlation_id: Optional[str] = None) -> Optional[str]:
    """Best-effort flight-recorder emit — telemetry must never take
    down a snapshot or restore."""
    try:
        from ..observe import events as events_mod

        return events_mod.record_event(
            kind, severity=severity, payload=payload, cause_id=cause_id,
            correlation_id=correlation_id,
            rank=env_util.get_int(env_util.HVD_PROCESS_ID, 0))
    except Exception:  # noqa: BLE001
        return None


def _metric(name: str, *labels, n: float = 1, set_value: bool = False):
    try:
        from .. import metrics

        if not metrics.on():
            return
        fam = getattr(metrics, name)
        inst = fam.labels(*labels) if labels else fam
        if set_value:
            inst.set(n)
        else:
            inst.inc(n)
    except Exception:  # noqa: BLE001
        pass


def _epoch_chain() -> Tuple[Optional[str], Optional[str]]:
    """(cause_id, correlation_id) of the current membership epoch record
    so restore events chain onto the abort/epoch incident across
    processes (observe/events.py)."""
    try:
        from . import membership

        rec = membership.current_record()
        if rec:
            return rec.get("event_id"), rec.get("correlation_id")
    except Exception:  # noqa: BLE001
        pass
    return None, None


class PeerSnapshotManager:
    """One rank's half of the peer state plane: the shard server it
    donates to its peers, the background snapshotter, and the
    restore/reprotect logic.

    The manager is wired at the same rendezvous the membership plane
    uses (``HVD_METRICS_KV_ADDR``/``PORT``/``HVD_METRICS_SECRET``);
    tests pass ``addr``/``port``/``secret`` explicitly."""

    def __init__(self, *, replicas_k: Optional[int] = None,
                 nshards: Optional[int] = None,
                 keep: Optional[int] = None,
                 addr: Optional[str] = None, port: Optional[int] = None,
                 secret: Optional[bytes] = None,
                 worker: Optional[str] = None,
                 rank: Optional[int] = None):
        self.k = int(replicas_k if replicas_k is not None else replicas())
        self.nshards = int(nshards if nshards is not None else
                           env_util.get_int(env_util.HVD_SNAPSHOT_SHARDS,
                                            env_util.DEFAULT_SNAPSHOT_SHARDS))
        self.keep = max(int(keep if keep is not None else env_util.get_int(
            env_util.HVD_SNAPSHOT_KEEP, env_util.DEFAULT_SNAPSHOT_KEEP)), 1)
        self.timeout = env_util.get_float(
            env_util.HVD_SNAPSHOT_TIMEOUT_SECONDS,
            env_util.DEFAULT_SNAPSHOT_TIMEOUT_SECONDS)
        self.copy_arrays = env_util.get_bool(env_util.HVD_SNAPSHOT_COPY)
        if addr is None or port is None:
            from .abort import _rendezvous_from_env

            wired = _rendezvous_from_env()
            if wired is None:
                raise RuntimeError(
                    "peer state plane needs the launcher rendezvous wiring "
                    "(HVD_METRICS_KV_ADDR/PORT) or explicit addr/port")
            addr, port, secret = wired
        self.addr, self.port, self.secret = addr, int(port), secret
        if worker is None:
            from . import membership

            worker = membership.worker_id()
        self.worker = str(worker)
        self._rank = rank
        # own shard server (donated host memory peers replicate into)
        self.server = None
        self._server_port: Optional[int] = None
        # local shard cache: gen -> [(key, bytes)] — what reprotect
        # re-pushes without re-serializing (survivors only; a restarted
        # process has no cache and simply snapshots again)
        self._local: Dict[int, List[Tuple[str, bytes]]] = {}
        self._my_gens: List[int] = []   # own committed gens, oldest first
        # latest-wins snapshot slot + the daemon that drains it; a slot
        # item is (skeleton, step, buffer set index, copy-done event)
        self._slot: Optional[Tuple[Any, int, int, Any]] = None
        # two snapshot buffer sets; the one the thread is reading is busy
        self._buffers: List[Optional[_Buffers]] = [None, None]
        self._busy: Optional[int] = None
        self._d2h: Dict[torch.device, Any] = {}
        self._slot_lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_stall_us: float = 0.0
        self.last_failure: Optional[str] = None
        self.snapshots = 0
        self.failures = 0

    # -- rank / wiring -----------------------------------------------------
    @property
    def rank(self) -> int:
        if self._rank is not None:
            return self._rank
        return env_util.get_int(env_util.HVD_PROCESS_ID, 0)

    def start(self) -> int:
        """Start the shard server and register its endpoint under
        ``peerstate/addr.<worker>``.  Idempotent."""
        from ..run.http_client import put_kv
        from ..run.http_server import (PEER_ADDR_PREFIX, PEERSTATE_SCOPE,
                                       RendezvousServer)

        if self.server is None:
            self.server = RendezvousServer(secret=self.secret)
            self._server_port = self.server.start()
        record = {"worker": self.worker, "host": self._host_label(),
                  "addr": self._advertise_addr(),
                  "port": self._server_port, "time": time.time()}
        put_kv(self.addr, self.port, PEERSTATE_SCOPE,
               f"{PEER_ADDR_PREFIX}{self.worker}",
               json.dumps(record).encode(), secret=self.secret, retry=True)
        return self._server_port

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.server is not None:
            self.server.stop()
            self.server = None

    def _host_label(self) -> str:
        """The placement label peers are spread across — the relay
        tree's host slug, so the peer tier and the aggregation tree
        agree on what 'one host' means."""
        try:
            from ..run.relay import host_slug

            return host_slug()
        except Exception:  # noqa: BLE001
            return socket.gethostname() or "localhost"

    def _advertise_addr(self) -> str:
        """The address peers dial for this worker's shard server."""
        addr = env_util.get_str(env_util.HVD_RING_HOST)
        if addr:
            return addr
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.connect((self.addr, self.port or 1))
                return s.getsockname()[0]
            finally:
                s.close()
        except OSError:
            return "127.0.0.1"

    def _addr_table(self) -> Dict[str, dict]:
        """Registered shard-server endpoints (``addr.<worker>``)."""
        from ..run.http_client import get_scope
        from ..run.http_server import PEER_ADDR_PREFIX, PEERSTATE_SCOPE

        out: Dict[str, dict] = {}
        try:
            res = get_scope(self.addr, self.port, PEERSTATE_SCOPE,
                            secret=self.secret)
        except (urllib.error.URLError, OSError) as e:
            log.debug("peerstate addr table read failed: %s", e)
            return out
        for key, raw in res.get("entries", {}).items():
            if not key.startswith(PEER_ADDR_PREFIX):
                continue
            try:
                out[key[len(PEER_ADDR_PREFIX):]] = json.loads(raw)
            except (ValueError, TypeError):
                continue
        return out

    def _live_world(self, addrs: Dict[str, dict]) -> Dict[str, dict]:
        """Peer candidates: registered endpoints restricted to the
        committed membership world when one exists (a removed worker's
        stale registration must not hold replicas)."""
        try:
            from . import membership

            rec = membership.current_record()
            if rec and rec.get("world"):
                world = set(rec["world"])
                world.add(self.worker)
                return {w: a for w, a in addrs.items() if w in world}
        except Exception:  # noqa: BLE001
            pass
        return addrs

    # -- the step-path call ------------------------------------------------
    def snapshot(self, state: Any, step: int) -> float:
        """Enqueue an async snapshot of ``state`` as generation
        ``step``.  This is the ONLY thing the step path pays: a
        container rebuild (so later in-place dict/list updates cannot
        reach the parked snapshot — see :func:`_detach`; numpy leaves
        are also copied under ``HVD_SNAPSHOT_COPY=1``), one grouped copy
        of every tensor into a snapshot buffer, enqueued on the current
        stream (so it reads the values the step's work left, and a later
        in-place update cannot reach it), plus a slot write + event set.
        Latest-wins: a slow upload skips intermediate generations rather
        than queueing them."""
        t0 = time.perf_counter()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._drain_loop, daemon=True, name="hvd-snapshot")
            self._thread.start()
        tensors: List[torch.Tensor] = []
        skeleton = _detach(state, self.copy_arrays, tensors)
        with self._slot_lock:
            # latest wins: a parked item the thread has not taken is
            # dropped, and its buffer set is free again
            self._slot = None
            index = 1 if self._busy == 0 else 0
        buf = self._buffers[index]
        if buf is None or buf.sig != _signature(tensors):
            buf = self._buffers[index] = _Buffers(tensors)
        done = None
        if tensors:
            with torch.no_grad():
                torch._foreach_copy_(buf.dev, tensors)
            if any(t.is_cuda for t in tensors):
                done = torch.cuda.Event()
                done.record()
        with self._slot_lock:
            # _idle transitions pair with the slot under one lock, so
            # the drain loop's idle re-check can never race a fresh
            # enqueue into a stale "drained" verdict
            self._slot = (skeleton, int(step), index, done)
            self._idle.clear()
        self._wake.set()
        stall = time.perf_counter() - t0
        self.last_stall_us = stall * 1e6
        _metric("SNAPSHOT_STALL_US", n=self.last_stall_us, set_value=True)
        return stall

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the background snapshotter is idle (tests,
        bench, clean shutdown).  True when it drained in time."""
        return self._idle.wait(timeout)

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            while True:
                with self._slot_lock:
                    item, self._slot = self._slot, None
                    if item is not None:
                        self._busy = item[2]
                if item is None:
                    break
                step = item[1]
                try:
                    try:
                        payload = self._serialize(item)
                    finally:
                        with self._slot_lock:
                            self._busy = None
                    self._publish(payload, step)
                except Exception as e:  # noqa: BLE001 — the snapshotter
                    # must never take down training; the storage tier
                    # remains the durable backstop
                    self.failures += 1
                    self.last_failure = f"{type(e).__name__}: {e}"
                    _metric("SNAPSHOT_FAILURES")
                    log.warning("async snapshot of step %s failed: %s",
                                step, self.last_failure)
            with self._slot_lock:
                if self._slot is None:
                    self._idle.set()

    def _serialize(self, item) -> bytes:
        """The parked snapshot's pickle: wait for its device copy, copy
        the buffer to pinned host memory on a side stream, and pickle the
        state with its leaves as numpy arrays (:func:`to_numpy`)."""
        skeleton, _, index, done = item
        buf = self._buffers[index]
        if done is not None:
            device = next(t.device for t in buf.dev if t.is_cuda)
            stream = self._d2h.get(device)
            if stream is None:
                stream = self._d2h[device] = torch.cuda.Stream(device)
            with torch.cuda.stream(stream):
                stream.wait_event(done)
                pairs = [(h, d) for h, d in zip(buf.host, buf.dev)
                         if d.is_cuda]
                torch._foreach_copy_([h for h, _ in pairs],
                                     [d for _, d in pairs],
                                     non_blocking=True)
            stream.synchronize()
        return pickle.dumps(to_numpy(_refill(skeleton, buf.host)))

    # -- the snapshot body (also callable synchronously in tests) ----------
    def snapshot_sync(self, state: Any, step: int) -> dict:
        """Serialize ``state`` (its values now), push shards to K peers,
        write manifest then commit marker for generation ``step``.
        Returns the manifest."""
        return self._publish(pickle.dumps(to_numpy(state)), step)

    def _publish(self, payload: bytes, step: int) -> dict:
        """Push ``payload``'s shards to K peers, then write the manifest
        and the commit marker of generation ``step``."""
        from ..run.http_client import push_shard, put_kv
        from ..run.http_server import (PEERSTATE_SCOPE,
                                       SNAPSHOT_COMMIT_PREFIX,
                                       SNAPSHOT_MANIFEST_PREFIX)

        gen = int(step)
        begin_eid = _flight_event("snapshot.begin",
                                  {"gen": gen, "rank": self.rank,
                                   "worker": self.worker})
        t0 = time.perf_counter()
        shards = shard_payload(payload, self.nshards)
        addrs = self._live_world(self._addr_table())
        peers = choose_peers(self.worker, addrs, self.k)
        if not peers:
            raise RuntimeError(
                f"no peer shard servers registered (worker {self.worker}; "
                "did peers call PeerSnapshotManager.start()?)")
        manifest: dict = {"gen": gen, "step": gen, "rank": self.rank,
                          "worker": self.worker,
                          "world_size": self._world_size(addrs),
                          "shards": [], "time": time.time()}
        local: List[Tuple[str, bytes]] = []
        for idx, data in enumerate(shards):
            key = f"{gen}.{self.rank}.{idx}"
            crc = checksum(data)
            wire = faults.on_peer_push(data)  # kind=corrupt flips bytes
            for peer in peers:
                rec = addrs.get(peer) or {}
                push_shard(rec.get("addr", "127.0.0.1"),
                           int(rec.get("port", 0)), key, wire,
                           secret=self.secret, timeout=self.timeout)
            manifest["shards"].append({"idx": idx, "bytes": len(data),
                                       "crc": crc, "peers": list(peers)})
            local.append((key, data))
        put_kv(self.addr, self.port, PEERSTATE_SCOPE,
               f"{SNAPSHOT_MANIFEST_PREFIX}{gen}.{self.rank}",
               json.dumps(manifest).encode(), secret=self.secret, retry=True)
        # commit semantics: the marker is written ONLY after every
        # shard landed — a rank that dies mid-upload leaves gen
        # uncommitted and restore skips it
        put_kv(self.addr, self.port, PEERSTATE_SCOPE,
               f"{SNAPSHOT_COMMIT_PREFIX}{gen}.{self.rank}",
               json.dumps({"gen": gen, "worker": self.worker,
                           "time": time.time()}).encode(),
               secret=self.secret, retry=True)
        self._local[gen] = local
        self._my_gens.append(gen)
        self.snapshots += 1
        self.last_failure = None
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        _metric("SNAPSHOTS_TOTAL")
        _metric("SNAPSHOT_BYTES", n=len(payload))
        _metric("SNAPSHOT_GEN", n=gen, set_value=True)
        _flight_event("snapshot.commit",
                      {"gen": gen, "rank": self.rank, "bytes": len(payload),
                       "shards": len(shards), "peers": peers,
                       "upload_ms": round(elapsed_ms, 3)},
                      cause_id=begin_eid)
        self._gc()
        return manifest

    def _world_size(self, addrs: Dict[str, dict]) -> int:
        try:
            from . import membership

            rec = membership.current_record()
            if rec and rec.get("world"):
                return len(rec["world"])
        except Exception:  # noqa: BLE001
            pass
        n = env_util.get_int(env_util.HVD_NUM_PROCESSES, 0)
        return n if n > 0 else max(len(addrs), 1)

    def _gc(self) -> None:
        """Retire own generations beyond ``keep``, cleared-before-
        overwrite: the commit marker goes FIRST (the generation stops
        being restorable), then the replicated shards, then the
        manifest — a crash mid-GC can never leave a committed
        generation with missing shards."""
        from ..run.http_client import delete_kv
        from ..run.http_server import (PEERSTATE_SCOPE,
                                       SNAPSHOT_COMMIT_PREFIX,
                                       SNAPSHOT_MANIFEST_PREFIX, SHARD_SCOPE
                                       as SERVER_SHARD_SCOPE)

        while len(self._my_gens) > self.keep:
            gen = self._my_gens.pop(0)
            try:
                delete_kv(self.addr, self.port, PEERSTATE_SCOPE,
                          f"{SNAPSHOT_COMMIT_PREFIX}{gen}.{self.rank}",
                          secret=self.secret)
                addrs = self._addr_table()
                for key, _ in self._local.get(gen, ()):  # then the shards
                    for peer, rec in addrs.items():
                        if peer == self.worker:
                            continue
                        try:
                            delete_kv(rec.get("addr", "127.0.0.1"),
                                      int(rec.get("port", 0)),
                                      SERVER_SHARD_SCOPE, key,
                                      secret=self.secret)
                        except (urllib.error.URLError, OSError):
                            pass  # a dead peer's copies die with it
                delete_kv(self.addr, self.port, PEERSTATE_SCOPE,
                          f"{SNAPSHOT_MANIFEST_PREFIX}{gen}.{self.rank}",
                          secret=self.secret)
            except (urllib.error.URLError, OSError) as e:
                log.debug("snapshot GC of gen %s failed: %s", gen, e)
            self._local.pop(gen, None)

    # -- restore -----------------------------------------------------------
    def _manifests(self) -> Dict[int, Dict[int, dict]]:
        """``{gen: {rank: manifest}}`` from the rendezvous, plus commit
        markers folded in as ``manifest['_committed']``."""
        from ..run.http_client import get_scope
        from ..run.http_server import (PEERSTATE_SCOPE,
                                       SNAPSHOT_COMMIT_PREFIX,
                                       SNAPSHOT_MANIFEST_PREFIX)

        res = get_scope(self.addr, self.port, PEERSTATE_SCOPE,
                        secret=self.secret)
        gens: Dict[int, Dict[int, dict]] = {}
        committed: set = set()
        for key, raw in res.get("entries", {}).items():
            if key.startswith(SNAPSHOT_MANIFEST_PREFIX):
                gen_s, _, rank_s = \
                    key[len(SNAPSHOT_MANIFEST_PREFIX):].partition(".")
                if not (gen_s.isdigit() and rank_s.isdigit()):
                    continue
                try:
                    gens.setdefault(int(gen_s), {})[int(rank_s)] = \
                        json.loads(raw)
                except (ValueError, TypeError):
                    continue
            elif key.startswith(SNAPSHOT_COMMIT_PREFIX):
                gen_s, _, rank_s = \
                    key[len(SNAPSHOT_COMMIT_PREFIX):].partition(".")
                if gen_s.isdigit() and rank_s.isdigit():
                    committed.add((int(gen_s), int(rank_s)))
        for gen, by_rank in gens.items():
            for rank, m in by_rank.items():
                m["_committed"] = (gen, rank) in committed
        return gens

    def resolve_committed(self) -> Optional[int]:
        """Newest generation whose EVERY rank wrote both manifest and
        commit marker — the only generations restore may target
        (uncommitted newest generations are skipped, the peer-tier
        analog of ``latest_step`` ignoring torn ``step_N`` dirs)."""
        try:
            gens = self._manifests()
        except (urllib.error.URLError, OSError) as e:
            self.last_failure = f"manifest read failed: {e}"
            return None
        for gen in sorted(gens, reverse=True):
            by_rank = gens[gen]
            if 0 not in by_rank:
                continue
            # the world this gen must cover is the LARGEST any of its
            # manifests recorded — rank 0's view alone can be stale
            # across a concurrent grow (ranks >= its world_size
            # committed the same gen with a larger world), and trusting
            # it would deem the gen whole with those ranks unchecked
            world = max((int(m.get("world_size") or 0)
                         for m in by_rank.values()), default=0) \
                or len(by_rank)
            if all(r in by_rank and by_rank[r].get("_committed")
                   for r in range(world)):
                return gen
        return None

    def restore(self, like: Any = None, *, gen: Optional[int] = None,
                rank: Optional[int] = None
                ) -> Optional[Tuple[Any, int]]:
        """Pull this rank's shards of the newest fully-committed
        generation from live peers, verify checksums, and return
        ``(state, step)`` — the values loaded into ``like``'s tensors in
        place when it is given (:func:`load_into`), the unpickled tree
        otherwise — or ``None`` when no generation is
        restorable or any shard is unrecoverable (every replica dead or
        corrupt); the caller then falls back wholesale to the storage
        tier.  Per-shard, each replica is tried in manifest order
        before the shard is declared lost."""
        from ..run.http_client import pull_shard

        rank = self.rank if rank is None else int(rank)
        if gen is None:
            gen = self.resolve_committed()
        if gen is None:
            self.last_failure = self.last_failure or \
                "no fully-committed generation"
            return None
        try:
            manifest = self._manifests().get(gen, {}).get(rank)
        except (urllib.error.URLError, OSError) as e:
            self.last_failure = f"manifest read failed: {e}"
            return None
        if manifest is None:
            self.last_failure = (f"gen {gen} has no manifest for rank "
                                 f"{rank} (world resized?)")
            return None
        addrs = self._addr_table()
        pieces: List[bytes] = []
        for shard in manifest.get("shards", ()):
            key = f"{gen}.{rank}.{shard['idx']}"
            data = None
            for peer in shard.get("peers", ()):
                rec = addrs.get(peer)
                if rec is None:
                    continue
                try:
                    faults.on_peer_pull(key)  # peer-death-mid-restore seam
                    raw = pull_shard(rec.get("addr", "127.0.0.1"),
                                     int(rec.get("port", 0)), key,
                                     secret=self.secret,
                                     timeout=self.timeout)
                except (urllib.error.URLError, OSError) as e:
                    log.warning("shard %s pull from peer %s failed: %s",
                                key, peer, e)
                    continue
                if raw is None:
                    continue
                if checksum(raw) != shard.get("crc"):
                    log.warning("shard %s from peer %s failed its "
                                "checksum (corrupt replica)", key, peer)
                    continue
                data = raw
                break
            if data is None:
                self.last_failure = (f"shard {key}: no live peer holds an "
                                     "intact replica")
                log.warning("peer restore of gen %s abandoned: %s",
                            gen, self.last_failure)
                return None
            pieces.append(data)
        state = pickle.loads(b"".join(pieces))
        if like is not None:
            state = load_into(like, state)
        self.last_failure = None
        return state, int(manifest.get("step", gen))

    # -- elastic redistribution --------------------------------------------
    def reprotect(self) -> int:
        """Restore K-redundancy after a shrink: re-push shards of this
        rank's newest committed generation whose recorded replicas left
        the world, and rewrite the manifest.  Returns shards re-pushed
        (0 when redundancy is intact or there is no local cache — a
        restarted process simply snapshots again)."""
        from ..run.http_client import push_shard, put_kv
        from ..run.http_server import (PEERSTATE_SCOPE,
                                       SNAPSHOT_MANIFEST_PREFIX)

        if not self._my_gens:
            return 0
        gen = self._my_gens[-1]
        local = dict(self._local.get(gen, ()))
        if not local:
            return 0
        try:
            manifest = self._manifests().get(gen, {}).get(self.rank)
        except (urllib.error.URLError, OSError):
            return 0
        if manifest is None:
            return 0
        addrs = self._live_world(self._addr_table())
        live = set(addrs)
        repushed = 0
        changed = False
        short: List[str] = []
        for shard in manifest.get("shards", ()):
            holders = [p for p in shard.get("peers", ()) if p in live]
            if holders != list(shard.get("peers", ())):
                changed = True  # prune dead holders from the manifest
            lost = self.k - len(holders)
            if lost <= 0:
                shard["peers"] = holders
                continue
            key = f"{gen}.{self.rank}.{shard['idx']}"
            data = local.get(key)
            if data is None:
                shard["peers"] = holders
                short.append(key)
                continue
            # candidate pool: the live world with surviving holders
            # excluded UP FRONT — filtering choose_peers' ring prefix
            # after the fact can return fewer than `lost` fresh peers
            # when host labels shifted across the shrink
            pool = {w: a for w, a in addrs.items()
                    if w == self.worker or w not in holders}
            for peer in choose_peers(self.worker, pool, lost):
                rec = addrs.get(peer) or {}
                try:
                    push_shard(rec.get("addr", "127.0.0.1"),
                               int(rec.get("port", 0)), key, data,
                               secret=self.secret, timeout=self.timeout)
                except (urllib.error.URLError, OSError) as e:
                    log.warning("reprotect push of %s to %s failed: %s",
                                key, peer, e)
                    continue
                holders.append(peer)
                repushed += 1
                changed = True
            shard["peers"] = holders
            if len(holders) < self.k:
                short.append(key)
        if short:
            # partial reprotection is NOT silent: redundancy stays
            # below K until more peers join (the next epoch hook
            # retries) — the storage tier remains the durable backstop
            log.warning("reprotect of gen %s left %d shard(s) under-"
                        "replicated (< %d replicas): %s — not enough "
                        "live peers outside the surviving holders",
                        gen, len(short), self.k, ", ".join(short))
        if changed:
            put_kv(self.addr, self.port, PEERSTATE_SCOPE,
                   f"{SNAPSHOT_MANIFEST_PREFIX}{gen}.{self.rank}",
                   json.dumps({k: v for k, v in manifest.items()
                               if k != "_committed"}).encode(),
                   secret=self.secret, retry=True)
        if changed or short:
            _metric("SNAPSHOT_REPROTECTED", n=repushed)
            _flight_event("snapshot.reprotect",
                          {"gen": gen, "rank": self.rank,
                           "shards": repushed,
                           "under_replicated": len(short)},
                          severity="warning")
        return repushed

    def on_epoch(self, rec: Optional[dict] = None) -> None:
        """Membership epoch hook (membership.run / join_world): the
        world changed — re-register this worker's endpoint (the rank
        may have moved) and restore replica redundancy."""
        try:
            self.start()
            self.reprotect()
        except Exception as e:  # noqa: BLE001 — the hook must not fail
            log.warning("peerstate epoch hook failed: %s", e)  # a rebuild


# ---------------------------------------------------------------------------
# process-wide wiring (ElasticState + membership epoch hooks)
# ---------------------------------------------------------------------------
_instance: Optional[PeerSnapshotManager] = None
_lock = threading.Lock()


def manager(start: bool = True) -> PeerSnapshotManager:
    """The process-wide manager, built from env on first use (and its
    shard server started so this worker donates replica space even
    before its first snapshot)."""
    global _instance
    with _lock:
        if _instance is None:
            _instance = PeerSnapshotManager()
            if start:
                _instance.start()
        return _instance


def instance() -> Optional[PeerSnapshotManager]:
    return _instance


def on_epoch(rec: Optional[dict] = None) -> None:
    """Module-level epoch hook: no-op unless a manager exists."""
    m = _instance
    if m is not None:
        m.on_epoch(rec)


def reset() -> None:
    """Stop and drop the process manager (tests / shutdown)."""
    global _instance
    with _lock:
        if _instance is not None:
            _instance.stop()
            _instance = None
