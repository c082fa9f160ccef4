"""Mutation journal + warm-standby rendezvous server (HA control plane):
the port of ``horovod_tpu/run/journal.py``; its records are the
reference's, line for line.

Every control-plane subsystem — elastic membership, coordinated abort,
autotune plans, serving state — lives in the launcher's rendezvous KV
store, which makes the launcher a single point of failure: its death
would kill an ``--elastic`` job that is otherwise able to continue.  This module is the survivability half of the control-plane
tier (docs/control_plane.md):

* :class:`Journal` — an append-only JSONL log of KV mutations.  The
  primary :class:`~horovod_tpu_torch.run.http_server.RendezvousServer` (given
  ``journal_path``, usually via ``HVD_RENDEZVOUS_JOURNAL``) appends one
  record per put/delete/scope-clear **under the owning shard's lock**,
  so the log is a faithful per-key linearization.  High-churn,
  reconstructible scopes (``metrics``, ``sanitizer``, ``profile``,
  ``health``) are excluded by default: leases re-renew within one
  heartbeat interval of a failover and snapshots re-push, so journaling
  them would only bloat the log.
* :class:`JournalTailer` / :func:`read_entries` — replay: a tailer
  thread follows the journal (including across partial trailing lines
  mid-append) and applies each record to a store.
* :class:`StandbyServer` — a full RendezvousServer that tails the
  primary's journal into its own sharded store.  It serves the same
  HTTP surface with the same secret; when the primary dies, clients
  walk the ordered ``HVD_RENDEZVOUS_ADDRS`` list (run/http_client.py
  failover) and land here with membership epochs, the abort flag, and
  autotune/serving state intact.  Split-brain is prevented by **epoch
  fencing** in the server itself: ``/membership/epoch`` writes that do
  not advance the committed epoch are rejected with 409, so a stale
  primary resurrected after a takeover cannot roll the world back.

Run a standby out-of-process with ``scripts/hvd_standby.py`` (the
journal path must be reachable from both hosts — shared filesystem or a
synced copy).
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
from typing import List, Optional, Tuple

from ..utils.logging import get_logger
from .store import split_path

log = get_logger(__name__)

#: scopes whose traffic is high-churn and reconstructible after a
#: failover (leases re-renew, snapshots re-push, fingerprints re-check).
#: ``shard`` is raw peer-snapshot bytes (elastic/peerstate.py): they
#: live on the PEER workers' shard servers, are re-pushed by the next
#: snapshot, and must never bloat a journal — only their manifests
#: (the journaled ``peerstate`` scope) need to survive a failover.
JOURNAL_EXCLUDED_SCOPES = frozenset(
    {"metrics", "sanitizer", "profile", "health", "shard"})


class Journal:
    """Append-only JSONL journal of KV mutations.

    One record per line: ``{"op": "put"|"del"|"clear", "p": path,
    "t": wall-clock, ["v": base64 value]}``.  ``record`` is called with
    the owning shard lock held (run/store.py), so per-key ordering in
    the file matches the store; the internal lock serializes appends
    across shards."""

    def __init__(self, path: str,
                 exclude: frozenset = JOURNAL_EXCLUDED_SCOPES):
        self.path = str(path)
        self.exclude = frozenset(exclude)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self._closed = False
        self.records = 0

    def record(self, op: str, path: str,
               value: Optional[bytes] = None) -> None:
        if split_path(path)[0] in self.exclude:
            return
        rec = {"op": op, "p": path, "t": time.time()}
        if value is not None:
            rec["v"] = base64.b64encode(value).decode()
        line = (json.dumps(rec) + "\n").encode()
        with self._lock:
            if self._closed:
                # a straggling keep-alive handler thread after stop():
                # the mutation is lost WITH the server, which is fine —
                # raising here would 500 a teardown-window request
                return
            self._f.write(line)
            self._f.flush()
            self.records += 1

    def close(self) -> None:
        with self._lock:
            self._closed = True
            try:
                self._f.close()
            except ValueError:
                pass


def read_entries(path: str, offset: int = 0) -> Tuple[List[dict], int]:
    """Read complete journal records from ``offset``; returns the
    decoded records and the new offset.  A partial trailing line (the
    primary mid-append) is left for the next call; a corrupt complete
    line is skipped with a warning rather than wedging the tailer."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read()
    except FileNotFoundError:
        return [], offset
    if not data:
        return [], offset
    end = data.rfind(b"\n")
    if end < 0:
        return [], offset
    entries: List[dict] = []
    for line in data[:end].split(b"\n"):
        if not line.strip():
            continue
        try:
            entries.append(json.loads(line))
        except ValueError:
            log.warning("journal: skipping corrupt record at ~%d bytes",
                        offset)
    return entries, offset + end + 1


def apply_entry(store, rec: dict) -> None:
    """Apply one journal record to a ShardedKVStore.  Epoch writes are
    fenced at replay time too: a journal poisoned by a stale writer (a
    resurrected primary appending a regressed commit) must not roll a
    standby's committed epoch back — the skip mirrors the 409 the live
    surface would have answered."""
    op = rec.get("op")
    path = rec.get("p")
    if not isinstance(path, str):
        return
    value = None
    if "v" in rec:
        try:
            value = base64.b64decode(rec["v"])
        except (ValueError, TypeError):
            return
    if op == "put" and value is not None:
        from .http_server import EPOCH_PATH, _epoch_of

        if path == EPOCH_PATH:
            cur_raw = store.get(EPOCH_PATH)
            if cur_raw is not None:
                cur, new = _epoch_of(cur_raw), _epoch_of(value)
                if cur is not None and (new is None or new < cur):
                    log.warning("journal replay: skipping regressed "
                                "membership epoch write (%s < %s)", new, cur)
                    return
    store.apply_replayed(op, path, value)


def replay(path: str, store) -> int:
    """Replay a whole journal into ``store``; returns the record count
    (the fast-recovery path and the unit-test surface)."""
    entries, _ = read_entries(path)
    for rec in entries:
        apply_entry(store, rec)
    return len(entries)


class JournalTailer(threading.Thread):
    """Follow a growing journal file, applying records to ``store``."""

    def __init__(self, path: str, store, poll_seconds: float = 0.05):
        super().__init__(daemon=True, name="hvd-journal-tailer")
        self.path = str(path)
        self.store = store
        self.poll_seconds = float(poll_seconds)
        self.offset = 0
        self.applied = 0
        self._stop_event = threading.Event()

    def catch_up(self) -> int:
        """Apply everything currently in the journal; returns how many
        records were applied this call."""
        entries, self.offset = read_entries(self.path, self.offset)
        for rec in entries:
            apply_entry(self.store, rec)
        self.applied += len(entries)
        return len(entries)

    def run(self) -> None:
        while not self._stop_event.is_set():
            if not self.catch_up():
                self._stop_event.wait(self.poll_seconds)
        self.catch_up()  # drain what arrived before the stop

    def stop(self) -> None:
        self._stop_event.set()


class StandbyServer:
    """A warm-standby rendezvous server: tails the primary's journal
    into its own store and serves the identical HTTP surface, so
    clients that fail over via ``HVD_RENDEZVOUS_ADDRS`` resume against
    live membership/abort/autotune state."""

    def __init__(self, journal_path: str, secret: Optional[bytes] = None,
                 port: int = 0, poll_seconds: float = 0.05):
        from .http_server import RendezvousServer

        # the standby never journals: replaying a replayed journal into
        # a third server is an operator decision, not a default loop
        self.server = RendezvousServer(secret=secret, port=port)
        self.tailer = JournalTailer(journal_path, self.server.store,
                                    poll_seconds=poll_seconds)

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def applied(self) -> int:
        return self.tailer.applied

    def start(self) -> int:
        self.tailer.catch_up()  # warm before serving
        self.tailer.start()
        port = self.server.start()
        log.info("standby rendezvous on port %d (journal %s, %d records "
                 "replayed)", port, self.tailer.path, self.applied)
        return port

    def stop(self) -> None:
        self.tailer.stop()
        self.server.stop()
