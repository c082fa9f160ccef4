"""Sharded key-value store backing the rendezvous server: the port of
``horovod_tpu/run/store.py``, as it is.

One ``dict`` guarded by ONE lock inside ``RendezvousServer`` would
funnel every control-plane family — health leases, membership epochs,
sanitizer fingerprints, autotune plans, metric snapshots, serving
pulls.  At thousand-rank worlds that lock is the
contention point: a sanitizer fingerprint storm serializes behind
heartbeat renewals which serialize behind a 100 KiB metrics snapshot
PUT.  This module replaces it (docs/control_plane.md):

* **Hash-sharded values.**  Keys (``/scope/key`` paths) are distributed
  over ``HVD_CP_SHARDS`` independent ``dict``+lock shards by CRC32 of
  the full path, so traffic in different scopes — and different keys of
  one hot scope — stops contending.  Single-key operations take exactly
  one shard lock; whole-store snapshots (the report builders) take each
  shard lock in turn, never all at once.
* **Per-scope versioning.**  Every mutation bumps its scope's version
  counter and records the key's version (deletes leave bounded
  tombstones), which is what makes the batch read protocol possible:
  ``GET /scope/<name>?since=V`` returns only the keys that changed
  after ``V`` plus the keys removed since — one HTTP round trip instead
  of one per key, with a ``full`` resync answer whenever the cursor
  predates the retained history (server restart, scope clear, pruned
  tombstones).
* **Journal hook.**  When the owning server was given a mutation
  journal (run/journal.py), every put/delete/clear is appended under
  the shard lock, so the journal is a faithful per-key linearization a
  warm-standby server can replay.

The store is process-internal: the HTTP surface, HMAC auth, and the
lease-time stamping stay in run/http_server.py.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional, Tuple

from ..utils import env as env_util

#: tombstones retained per scope before the oldest half is pruned (a
#: pruned window forces ``full`` resync for cursors that predate it)
TOMBSTONE_LIMIT = 1024


def split_path(path: str) -> Tuple[str, str]:
    """``/scope/key...`` → ``(scope, key)`` (key may contain slashes;
    a bare ``/scope`` yields an empty key)."""
    parts = path.lstrip("/").split("/", 1)
    scope = parts[0]
    key = parts[1] if len(parts) > 1 else ""
    return scope, key


class _ScopeMeta:
    """Per-scope version bookkeeping (guarded by the store's meta lock):
    ``version`` is the scope's mutation counter, ``keys`` maps live key →
    version-of-last-write, ``tombs`` maps deleted key → version-of-delete,
    and ``floor`` is the version below which history was discarded (scope
    clear or tombstone pruning) — a ``since`` cursor under the floor can
    only be answered with a full resync."""

    __slots__ = ("version", "keys", "tombs", "floor")

    def __init__(self) -> None:
        self.version = 0
        self.keys: Dict[str, int] = {}
        self.tombs: Dict[str, int] = {}
        self.floor = 0


class ShardedKVStore:
    """N-way sharded path → bytes store with per-scope change tracking."""

    def __init__(self, shards: Optional[int] = None, journal=None):
        n = int(shards if shards is not None
                else env_util.get_int(env_util.HVD_CP_SHARDS,
                                      env_util.DEFAULT_CP_SHARDS))
        self.num_shards = max(n, 1)
        self._shards: List[Dict[str, bytes]] = [
            {} for _ in range(self.num_shards)]
        self._locks = [threading.Lock() for _ in range(self.num_shards)]
        self._meta: Dict[str, _ScopeMeta] = {}
        self._meta_lock = threading.Lock()
        self.journal = journal

    # -- internals -----------------------------------------------------------
    def _shard_of(self, path: str) -> int:
        return zlib.crc32(path.encode()) % self.num_shards

    def _bump(self, path: str, *, delete: bool = False) -> None:
        """Record one mutation in the scope's version history."""
        scope, key = split_path(path)
        with self._meta_lock:
            meta = self._meta.get(scope)
            if meta is None:
                meta = self._meta[scope] = _ScopeMeta()
            meta.version += 1
            if delete:
                meta.keys.pop(key, None)
                meta.tombs[key] = meta.version
                if len(meta.tombs) > TOMBSTONE_LIMIT:
                    # prune the oldest half; cursors older than the
                    # highest pruned version fall back to a full resync
                    drop = sorted(meta.tombs.items(),
                                  key=lambda kv: kv[1])[:len(meta.tombs) // 2]
                    for k, ver in drop:
                        del meta.tombs[k]
                        meta.floor = max(meta.floor, ver)
            else:
                meta.tombs.pop(key, None)
                meta.keys[key] = meta.version

    def _journal(self, op: str, path: str,
                 value: Optional[bytes] = None) -> None:
        if self.journal is not None:
            self.journal.record(op, path, value)

    # -- point operations ----------------------------------------------------
    def get(self, path: str) -> Optional[bytes]:
        i = self._shard_of(path)
        with self._locks[i]:
            return self._shards[i].get(path)

    def put(self, path: str, value: bytes) -> None:
        i = self._shard_of(path)
        with self._locks[i]:
            self._shards[i][path] = value
            self._journal("put", path, value)
        self._bump(path)

    def pop(self, path: str) -> Optional[bytes]:
        i = self._shard_of(path)
        with self._locks[i]:
            old = self._shards[i].pop(path, None)
            if old is not None:
                self._journal("del", path)
        if old is not None:
            self._bump(path, delete=True)
        return old

    def __contains__(self, path: str) -> bool:
        return self.get(path) is not None

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    # -- bulk operations -----------------------------------------------------
    def items(self) -> Dict[str, bytes]:
        """A loosely consistent whole-store snapshot (shard locks taken
        one at a time) — the report builders' input."""
        out: Dict[str, bytes] = {}
        for i in range(self.num_shards):
            with self._locks[i]:
                out.update(self._shards[i])
        return out

    def prefix_items(self, prefix: str) -> Dict[str, bytes]:
        out: Dict[str, bytes] = {}
        for i in range(self.num_shards):
            with self._locks[i]:
                for k, v in self._shards[i].items():
                    if k.startswith(prefix):
                        out[k] = v
        return out

    def delete_matching(self, path: str) -> List[str]:
        """The HTTP DELETE semantics: drop the exact key and every key
        under ``path + '/'``.  Returns the deleted paths."""
        prefix = path.rstrip("/") + "/"
        deleted: List[str] = []
        for i in range(self.num_shards):
            with self._locks[i]:
                shard = self._shards[i]
                hits = [k for k in shard
                        if k.startswith(prefix) or k == path]
                for k in hits:
                    del shard[k]
                    self._journal("del", k)
                deleted.extend(hits)
        for k in deleted:
            self._bump(k, delete=True)
        return deleted

    def clear_scope(self, scope: str) -> None:
        """Drop every key under ``scope`` and reset its change history
        (readers' ``since`` cursors are invalidated → full resync).

        Every shard lock is held (in index order) across the delete AND
        the journal append: a concurrent put journals under its shard's
        lock, so no put can land between the clear emptying the shards
        and the clear reaching the journal — the replayed order matches
        what the primary's store actually observed.  Lock order is
        always shards (ascending) then the journal's internal lock, the
        same order a single put uses, so the two cannot deadlock."""
        prefix = f"/{scope}/"
        for lock in self._locks:
            lock.acquire()
        try:
            for shard in self._shards:
                for k in [k for k in shard if k.startswith(prefix)]:
                    del shard[k]
            self._journal("clear", f"/{scope}")
        finally:
            for lock in reversed(self._locks):
                lock.release()
        with self._meta_lock:
            meta = self._meta.get(scope)
            if meta is not None:
                meta.version += 1
                meta.floor = meta.version
                meta.keys.clear()
                meta.tombs.clear()

    def apply_replayed(self, op: str, path: str,
                       value: Optional[bytes]) -> None:
        """Apply one journal entry on a standby (never re-journaled —
        the standby's store has no journal attached by construction)."""
        if op == "put" and value is not None:
            self.put(path, value)
        elif op == "del":
            self.pop(path)
        elif op == "clear":
            self.clear_scope(split_path(path)[0])

    # -- the batch-read protocol --------------------------------------------
    def scope_version(self, scope: str) -> int:
        with self._meta_lock:
            meta = self._meta.get(scope)
            return meta.version if meta is not None else 0

    def scope_since(self, scope: str,
                    since: Optional[int] = None) -> Dict[str, object]:
        """The ``GET /scope/<name>?since=V`` answer: ``{"version",
        "full", "entries": {key: bytes}, "removed": [keys]}``.

        ``since=None`` (or a cursor outside the retained history — under
        the pruning floor, or AHEAD of the current version, which means
        the cursor came from a different server incarnation) returns a
        full snapshot with ``full=True``; otherwise only the keys whose
        last write is newer than ``since`` plus the tombstoned keys."""
        prefix = f"/{scope}/"
        with self._meta_lock:
            meta = self._meta.get(scope)
            if meta is None:
                return {"version": 0, "full": True, "entries": {},
                        "removed": []}
            version = meta.version
            full = (since is None or since < meta.floor or since > version)
            if full:
                wanted = None
                removed: List[str] = []
            else:
                wanted = [k for k, ver in meta.keys.items() if ver > since]
                removed = [k for k, ver in meta.tombs.items() if ver > since]
        entries: Dict[str, bytes] = {}
        if wanted is None:
            entries = {k[len(prefix):]: v
                       for k, v in self.prefix_items(prefix).items()}
        else:
            for key in wanted:
                val = self.get(prefix + key)
                if val is not None:
                    entries[key] = val
        return {"version": version, "full": bool(full),
                "entries": entries, "removed": sorted(removed)}
