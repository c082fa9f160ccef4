"""HTTP key-value store + rendezvous server: the port of
``horovod_tpu/run/http_server.py``, byte for byte on the wire (paths,
scopes, HMAC signatures, JSON and base64 bodies, replies and reports).

Re-design of the launcher-side rendezvous service (reference
horovod/run/http/http_server.py: ``KVStoreHandler`` with GET/PUT of
scope/key → bytes at :33-102, ``RendezvousServer`` where DELETE finalizes;
used by Gloo's HTTPStore from C++ during hvd.init, reference
gloo/gloo_context.cc:56-76, and by func-mode result collection,
run/run.py:813-832).

Here the same server carries the launcher's function mode (pickled fns
and results, run/run.py) and every control-plane push; the job's
``torch.distributed`` store is a separate ``TCPStore`` the launcher
holds (run/run.py).  Requests carry an HMAC signature derived from the job secret
(reference run/common/util/secret.py:26-30) — unauthenticated requests are
rejected.

It is also the job's metrics aggregation point: workers push JSON
registry snapshots into the ``metrics`` scope (horovod_tpu_torch/metrics/
push.py), and a signed ``GET /metrics`` renders every rank's snapshot —
plus the launcher's own registry — as one Prometheus text page
(``GET /metrics.json`` serves the raw merged snapshots).  The collective
sanitizer (analysis/sanitizer.py, HVD_SANITIZER=1) publishes per-dispatch
fingerprints into the ``sanitizer`` scope; ``GET /sanitizer`` renders
the live table grouped by sequence number then rank.

The failure-domain runtime rides it too (docs/fault_tolerance.md): ranks
renew heartbeat leases under ``/health/<rank>`` (stamped on the server's
clock at receipt), ``GET /health`` reports per-rank lease age with
live/stale/dead verdicts plus the job-wide abort flag, and the
``/abort/flag`` key is the coordinated-abort protocol's single source of
truth.

**Control-plane tier (docs/control_plane.md).**  The store behind this
surface is the sharded :class:`~horovod_tpu_torch.run.store.ShardedKVStore`
(``HVD_CP_SHARDS`` independent dict+lock shards with per-scope change
tracking), and three wire additions make thousand-rank worlds cheap and
survivable:

* ``PUT /batch`` — one signed request carrying many KV entries
  (``{"entries": [{"p": "/scope/key", "v": <base64>}, ...]}``), the
  upstream leg of the per-host relay tree (run/relay.py).  The reply
  carries the job-wide abort flag and the ``server_id``.
* ``GET /scope/<name>?since=V`` — scope-level batch read: only the keys
  changed after version ``V`` (plus removals), with a full-resync
  answer when the cursor predates the retained history.  The path
  prefix ``/scope/`` is reserved — a KV scope literally named "scope"
  cannot be served.
* a ``PUT`` under ``/health/`` answers with the abort verdict in the
  response body, collapsing the heartbeat's renew + abort-poll pair
  into one round trip (elastic/heartbeat.py).

Writes to ``/membership/epoch`` are **fenced**: an epoch that does not
advance the committed one is rejected (HTTP 409 /
:class:`EpochFencedError`), so a stale primary resurrected after a
warm-standby takeover (run/journal.py) cannot roll the world back.
``server_id`` (a per-incarnation random token carried in mutating
replies and scope reads) is how clients detect a failover and resync
their delta/cursor state.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import socket
import threading
import time
import uuid
from base64 import b64decode, b64encode
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..utils.logging import get_logger
from .store import ShardedKVStore

log = get_logger(__name__)

SECRET_HEADER = "X-Hvd-Signature"

METRICS_SCOPE = "metrics"
_METRICS_PREFIX = f"/{METRICS_SCOPE}/"

# collective-sanitizer fingerprints (analysis/sanitizer.py): keys are
# "<seq>.<rank>" → JSON fingerprint; GET /sanitizer renders the table
SANITIZER_SCOPE = "sanitizer"
_SANITIZER_PREFIX = f"/{SANITIZER_SCOPE}/"

# replay-engine summary (timeline/replay/): scripts/hvd_replay.py pushes
# its JSON summary here; GET /replay serves the latest one.  GET /clock
# is the offset-estimation handshake the per-rank timelines use at init.
REPLAY_SCOPE = "replay"
REPLAY_SUMMARY_KEY = "summary"

# digital-twin projection (timeline/replay/projection.py,
# docs/projection.md): `hvd_replay --project --push` publishes the
# topology-projected summary (per-target step time / efficiency / wire
# formats + the tracked projected-vs-measured accuracy record) here;
# GET /projection serves the latest one.
PROJECTION_SCOPE = "projection"
PROJECTION_SUMMARY_KEY = "summary"

# compute-anatomy profiler (timeline/profiler.py): each rank pushes its
# window anatomy under profile/<rank> at finalize; GET /profile renders
# the per-rank anatomies plus the cross-rank aggregate (per-segment
# slowest rank, mean MFU, worst host gap — docs/profiling.md)
PROFILE_SCOPE = "profile"
_PROFILE_PREFIX = f"/{PROFILE_SCOPE}/"

# profile-guided autotune loop (optim/profile_guided.py): the tuner (or
# scripts/hvd_autotune.py --push) publishes one record per plan event
# under plan.<n>; GET /autotune renders the per-plan table plus the
# latest predicted/realized speedup pair (docs/autotune.md contract)
AUTOTUNE_SCOPE = "autotune"
_AUTOTUNE_PREFIX = f"/{AUTOTUNE_SCOPE}/"
AUTOTUNE_PLAN_PREFIX = "plan."

# always-on telemetry time-series (metrics/timeseries.py): each rank's
# flusher lands its ring-buffer history under timeseries/<rank> — full
# snapshots or append-deltas merged server-side — and GET /timeseries
# renders the per-rank series (docs/observe.md)
TIMESERIES_SCOPE = "timeseries"
_TIMESERIES_PREFIX = f"/{TIMESERIES_SCOPE}/"

# online anomaly watchdog (observe/): alert records live
# under alerts/<id> (GET /alerts renders them newest-first), and the
# auto-arm broadcast — the KV-broadcast trace+profile start step every
# rank applies consistently — lives at observe/arm
ALERTS_SCOPE = "alerts"
_ALERTS_PREFIX = f"/{ALERTS_SCOPE}/"
OBSERVE_SCOPE = "observe"
ARM_KEY = "arm"

# control-plane flight recorder (observe/events.py): every lifecycle
# actor's structured events land under events/<id> (journaled — the
# audit trail survives warm-standby failover); GET /events renders them
# oldest-first with the scope version for cursor reads
EVENTS_SCOPE = "events"
_EVENTS_PREFIX = f"/{EVENTS_SCOPE}/"

# failure-domain runtime (elastic/heartbeat.py, elastic/abort.py): ranks
# renew leases under /health/<rank>; the server stamps each PUT on ITS
# clock and GET /health renders per-rank lease age + live/stale/dead
# verdicts.  The job-wide abort flag lives at /abort/flag.
HEALTH_SCOPE = "health"
_HEALTH_PREFIX = f"/{HEALTH_SCOPE}/"
ABORT_SCOPE = "abort"
ABORT_KEY = "flag"
# Spare-side liveness (elastic/membership.join_world ↔ driver.spares):
# a worker the driver HOLDS as a spare renews an announce-keyed lease at
# health/spare.<worker> between epoch waits.  The key is non-numeric on
# purpose — the driver's rank-lease expiry loop skips it — but the same
# STALE/DEAD verdict machinery applies, so a spare that dies while held
# is purged before admission instead of stalling a stability timeout.
SPARE_PREFIX = "spare."

# elastic membership (elastic/membership.py, elastic/driver.py): the
# committed epoch record lives at /membership/epoch; workers announce
# rejoin candidacy under announce.<worker>, acknowledge a rebuilt epoch
# under ready.<epoch>.<worker>, and rank 0 broadcasts the live training
# state under state.<epoch>.  GET /membership renders the whole table.
MEMBERSHIP_SCOPE = "membership"
_MEMBERSHIP_PREFIX = f"/{MEMBERSHIP_SCOPE}/"
EPOCH_KEY = "epoch"
BLOCKLIST_KEY = "blocklist"
ANNOUNCE_PREFIX = "announce."
READY_PREFIX = "ready."
STATE_PREFIX = "state."
# lossless scale-down handshake (elastic/driver.py remove(drain=True) ↔
# the departing worker): the driver requests under drain.<worker>, the
# worker stops pulling, finishes in flight, and acks under
# drain_ack.<worker>; only then is the shrink epoch committed.
DRAIN_PREFIX = "drain."
DRAIN_ACK_PREFIX = "drain_ack."
# a worker that received a preemption notice (cloud maintenance, or a
# kind=preempt fault) publishes it under preempt.<worker>; the elastic
# driver's poll turns the notice into a planned drain+snapshot
# (elastic/driver.preempt) instead of waiting for the lease to die.
PREEMPT_PREFIX = "preempt."

EPOCH_PATH = f"/{MEMBERSHIP_SCOPE}/{EPOCH_KEY}"

# peer-replicated state plane (elastic/peerstate.py,
# docs/fault_tolerance.md#the-peer-state-plane): each worker registers
# its shard-server endpoint under peerstate/addr.<worker>; per-rank
# snapshot manifests land at manifest.<gen>.<rank> with checkpoint-style
# commit markers at commit.<gen>.<rank> gating which generation restore
# may target.  The scope is journaled, so the warm-standby/fencing
# machinery is the consistency story.  Raw shard BYTES never touch this
# server — they live on the peer workers' own shard servers under
# shard/<gen>.<src_rank>.<idx>.  GET /peerstate renders the table.
PEERSTATE_SCOPE = "peerstate"
_PEERSTATE_PREFIX = f"/{PEERSTATE_SCOPE}/"
PEER_ADDR_PREFIX = "addr."
SNAPSHOT_MANIFEST_PREFIX = "manifest."
SNAPSHOT_COMMIT_PREFIX = "commit."
SHARD_SCOPE = "shard"

# serving plane (serving/, docs/inference.md; ROADMAP item 14): the
# --serve attaches a ServingFrontend to this server — signed POST
# /infer (one inference request), POST /serving/pull + /serving/result
# (the remote-replica protocol), GET /serving (status page).

#: lease-age verdict thresholds, in units of the lease's own renewal
#: interval: a rank is ``stale`` past STALE_FACTOR missed intervals and
#: ``dead`` past DEAD_FACTOR — the server-side lease expiry.
STALE_FACTOR = 2.0
DEAD_FACTOR = 4.0


#: the batched-write route (one request, many KV entries) and the
#: reserved scope-read route prefix (GET /scope/<name>?since=V)
BATCH_PATH = "/batch"
SCOPE_ROUTE_PREFIX = "/scope/"


class EpochFencedError(RuntimeError):
    """A ``/membership/epoch`` write did not advance the committed
    epoch.  Raised on the in-process path; the HTTP surface answers
    409.  This is the split-brain fence: after a standby takeover, a
    resurrected stale primary (or a partitioned driver) cannot commit a
    regressed world."""


def sign(secret: bytes, path: str, body: bytes = b"") -> str:
    mac = hmac.new(secret, path.encode() + b"|" + body, hashlib.sha256)
    return mac.hexdigest()


def build_health_report(store: Dict[str, bytes],
                        lease_times: Dict[str, float],
                        now: Optional[float] = None) -> Dict[str, object]:
    """Per-rank lease ages and verdicts from a store snapshot, computed on
    the SERVER clock (lease expiry is server-side: a rank whose clock
    drifts — or whose process died — cannot keep its own lease alive).
    Shared by the GET /health handler and the in-process
    :meth:`RendezvousServer.health_report` the elastic driver polls."""
    now = time.monotonic() if now is None else now
    leases = {k[len(_HEALTH_PREFIX):]: v for k, v in store.items()
              if k.startswith(_HEALTH_PREFIX)}
    abort_raw = store.get(f"/{ABORT_SCOPE}/{ABORT_KEY}")
    ranks: Dict[str, object] = {}
    for rank, raw in leases.items():
        try:
            lease = json.loads(raw)
        except (ValueError, TypeError):
            lease = {}
        age = now - lease_times.get(_HEALTH_PREFIX + rank, now)
        interval = float(lease.get("interval", 0.0)) or 1.0
        if age <= STALE_FACTOR * interval:
            verdict = "live"
        elif age <= DEAD_FACTOR * interval:
            verdict = "stale"
        else:
            verdict = "dead"
        ranks[rank] = {
            "age_seconds": round(age, 3),
            "interval": interval,
            "count": lease.get("count"),
            "pid": lease.get("pid"),
            "verdict": verdict,
        }
    abort = None
    if abort_raw is not None:
        try:
            abort = json.loads(abort_raw)
        except (ValueError, TypeError):
            abort = {"reason": "<undecodable abort flag>"}
    return {"ranks": ranks, "abort": abort}


def build_membership_report(store: Dict[str, bytes]) -> Dict[str, object]:
    """The elastic-membership table from a store snapshot: the committed
    epoch record, pending rejoin announcements, per-epoch ready acks, and
    the flapping-host blocklist (GET /membership)."""

    def _load(raw):
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except (ValueError, TypeError):
            return "<undecodable>"

    keys = {k[len(_MEMBERSHIP_PREFIX):]: v for k, v in store.items()
            if k.startswith(_MEMBERSHIP_PREFIX)}
    announces = {k[len(ANNOUNCE_PREFIX):]: _load(v)
                 for k, v in keys.items() if k.startswith(ANNOUNCE_PREFIX)}
    ready: Dict[str, list] = {}
    for k in keys:
        if k.startswith(READY_PREFIX):
            epoch, _, worker = k[len(READY_PREFIX):].partition(".")
            ready.setdefault(epoch, []).append(worker)
    for workers in ready.values():
        workers.sort()
    # "drain_ack." keys never match the "drain." prefix (they diverge
    # at the underscore), so one startswith per family suffices
    drains = {k[len(DRAIN_PREFIX):]: _load(v) for k, v in keys.items()
              if k.startswith(DRAIN_PREFIX)}
    drain_acks = {k[len(DRAIN_ACK_PREFIX):]: _load(v)
                  for k, v in keys.items()
                  if k.startswith(DRAIN_ACK_PREFIX)}
    preempts = {k[len(PREEMPT_PREFIX):]: _load(v) for k, v in keys.items()
                if k.startswith(PREEMPT_PREFIX)}
    return {
        "epoch": _load(keys.get(EPOCH_KEY)),
        "announces": announces,
        "ready": ready,
        "blocklist": _load(keys.get(BLOCKLIST_KEY)) or [],
        "drains": drains,
        "drain_acks": drain_acks,
        "preempts": preempts,
    }


def build_peerstate_report(store: Dict[str, bytes]) -> Dict[str, object]:
    """The peer-state-plane table from a store snapshot (GET
    /peerstate): registered shard-server endpoints, per-generation
    manifest/commit coverage, and the newest fully-committed generation
    — the one :meth:`~horovod_tpu_torch.elastic.peerstate.PeerSnapshotManager.
    restore` would target.  A generation counts as committed only when
    every rank of its recorded world wrote both manifest and marker."""

    def _load(raw):
        try:
            return json.loads(raw)
        except (ValueError, TypeError):
            return "<undecodable>"

    keys = {k[len(_PEERSTATE_PREFIX):]: v for k, v in store.items()
            if k.startswith(_PEERSTATE_PREFIX)}
    addrs = {k[len(PEER_ADDR_PREFIX):]: _load(v)
             for k, v in keys.items() if k.startswith(PEER_ADDR_PREFIX)}
    gens: Dict[int, Dict[str, object]] = {}
    for k, v in keys.items():
        for prefix, field in ((SNAPSHOT_MANIFEST_PREFIX, "manifests"),
                              (SNAPSHOT_COMMIT_PREFIX, "commits")):
            if not k.startswith(prefix):
                continue
            gen_s, _, rank_s = k[len(prefix):].partition(".")
            if not (gen_s.isdigit() and rank_s.isdigit()):
                continue
            rec = gens.setdefault(int(gen_s),
                                  {"manifests": {}, "commits": []})
            if field == "manifests":
                rec["manifests"][rank_s] = _load(v)
            else:
                rec["commits"].append(int(rank_s))
    newest_committed = None
    for gen, rec in sorted(gens.items(), reverse=True):
        rec["commits"] = sorted(rec["commits"])
        root = rec["manifests"].get("0")
        world = (root or {}).get("world_size") if isinstance(root, dict) \
            else None
        world = int(world) if world else len(rec["manifests"])
        rec["world_size"] = world
        rec["committed"] = bool(world) and all(
            str(r) in rec["manifests"] and r in rec["commits"]
            for r in range(world))
        if rec["committed"] and newest_committed is None:
            newest_committed = gen
    return {
        "addrs": addrs,
        "generations": {str(g): r for g, r in sorted(gens.items())},
        "newest_committed": newest_committed,
    }


def build_profile_report(store: Dict[str, bytes]) -> Dict[str, object]:
    """The compute-anatomy table from a store snapshot: every pushed
    per-rank anatomy plus the cross-rank aggregate, computed by the SAME
    :func:`~horovod_tpu_torch.timeline.profiler.aggregate_anatomies` the
    offline CLI uses (``GET /profile``, docs/profiling.md)."""
    per_rank: Dict[str, object] = {}
    for k, v in store.items():
        if not k.startswith(_PROFILE_PREFIX):
            continue
        rank = k[len(_PROFILE_PREFIX):]
        try:
            per_rank[rank] = json.loads(v)
        except (ValueError, TypeError):
            per_rank[rank] = "<undecodable>"
    valid = {r: a for r, a in per_rank.items() if isinstance(a, dict)}
    aggregate = None
    if valid:
        from ..timeline.profiler import aggregate_anatomies

        aggregate = aggregate_anatomies(valid)
    return {"ranks": per_rank, "aggregate": aggregate}


def build_timeseries_report(store: Dict[str, bytes]) -> Dict[str, object]:
    """The time-series table from a store snapshot: each pushed rank's
    series (samples as ``[step, value]`` pairs, oldest first) plus a
    cross-rank summary — per series, every rank's latest value and
    sample count — so one ``GET /timeseries`` answers both "show me the
    history" and "which ranks are reporting" (docs/observe.md)."""
    ranks: Dict[str, object] = {}
    for k, v in store.items():
        if not k.startswith(_TIMESERIES_PREFIX):
            continue
        rank = k[len(_TIMESERIES_PREFIX):]
        try:
            doc = json.loads(v)
            ranks[rank] = doc if isinstance(doc, dict) \
                else "<undecodable>"
        except (ValueError, TypeError):
            ranks[rank] = "<undecodable>"
    summary: Dict[str, Dict[str, object]] = {}
    for rank, doc in ranks.items():
        if not isinstance(doc, dict):
            continue
        for name, entry in (doc.get("series") or {}).items():
            if not isinstance(entry, dict):
                continue
            samples = entry.get("samples") or []
            s = summary.setdefault(name, {"ranks": {}})
            last = samples[-1] if samples else None
            s["ranks"][rank] = {
                "count": len(samples),
                "last_step": entry.get("last_step"),
                "last": last[1] if isinstance(last, (list, tuple))
                and len(last) == 2 else None,
            }
    return {"ranks": ranks, "summary": summary}


def build_alerts_report(store: Dict[str, bytes]) -> Dict[str, object]:
    """The watchdog's alert log from a store snapshot, newest first —
    ``GET /alerts``'s body.  Each record is the detector-emitted
    ``{severity, signal, evidence, window}`` dict plus the ids/stamps
    and any auto-arm / attribution enrichment the watchdog attached
    (observe/watchdog.py, docs/observe.md)."""
    alerts = []
    for k, v in store.items():
        if not k.startswith(_ALERTS_PREFIX):
            continue
        key = k[len(_ALERTS_PREFIX):]
        try:
            rec = json.loads(v)
        except (ValueError, TypeError):
            rec = {"id": key, "error": "<undecodable>"}
        if isinstance(rec, dict):
            rec.setdefault("id", key)
        alerts.append(rec)

    def _order(rec):
        try:
            return int(rec.get("id"))
        except (ValueError, TypeError, AttributeError):
            return -1

    alerts.sort(key=_order, reverse=True)
    counts: Dict[str, int] = {}
    for rec in alerts:
        if isinstance(rec, dict) and rec.get("signal"):
            counts[rec["signal"]] = counts.get(rec["signal"], 0) + 1
    return {"alerts": alerts, "counts": counts}


def build_events_report(store: Dict[str, bytes],
                        since_ts: Optional[float] = None,
                        kind: Optional[str] = None) -> Dict[str, object]:
    """The flight-recorder log from a store snapshot, oldest first —
    ``GET /events``'s body.  Each record is the emitter's ``{id, ts,
    host, rank, kind, severity, correlation_id, cause_id, payload}``
    (observe/events.py).  ``since_ts``/``kind`` filter server-side so a
    following console doesn't re-ship the whole log every poll."""
    records = []
    for k, v in store.items():
        if not k.startswith(_EVENTS_PREFIX):
            continue
        key = k[len(_EVENTS_PREFIX):]
        try:
            rec = json.loads(v)
        except (ValueError, TypeError):
            rec = {"id": key, "error": "<undecodable>"}
        if isinstance(rec, dict):
            rec.setdefault("id", key)
        records.append(rec)
    if since_ts is not None:
        records = [r for r in records
                   if isinstance(r, dict)
                   and (r.get("ts") or 0.0) > since_ts]
    if kind:
        records = [r for r in records if isinstance(r, dict)
                   and str(r.get("kind", "")).startswith(kind)]
    records.sort(key=lambda r: ((r.get("ts") or 0.0)
                                if isinstance(r, dict) else 0.0,
                                str(r.get("id"))
                                if isinstance(r, dict) else ""))
    counts: Dict[str, int] = {}
    for rec in records:
        if isinstance(rec, dict) and rec.get("kind"):
            counts[rec["kind"]] = counts.get(rec["kind"], 0) + 1
    return {"events": records, "counts": counts}


def build_autotune_report(store: Dict[str, bytes]) -> Dict[str, object]:
    """The profile-guided tuning table from a store snapshot: every
    pushed plan record in sequence order, the latest record as
    ``current``, and the headline predicted/realized speedup pair —
    ``GET /autotune``'s body (docs/autotune.md)."""
    plans = []
    for k, v in store.items():
        if not k.startswith(_AUTOTUNE_PREFIX):
            continue
        key = k[len(_AUTOTUNE_PREFIX):]
        if not key.startswith(AUTOTUNE_PLAN_PREFIX):
            continue
        seq_s = key[len(AUTOTUNE_PLAN_PREFIX):]
        try:
            seq = int(seq_s)
        except ValueError:
            continue
        try:
            rec = json.loads(v)
        except (ValueError, TypeError):
            rec = "<undecodable>"
        plans.append({"seq": seq, "record": rec})
    plans.sort(key=lambda p: p["seq"])
    current = plans[-1]["record"] if plans else None
    report: Dict[str, object] = {"plans": plans, "current": current}
    if isinstance(current, dict):
        report["predicted_speedup_pct"] = current.get(
            "predicted_speedup_pct")
        report["realized_speedup_pct"] = current.get(
            "realized_speedup_pct")
        report["outcome"] = current.get("outcome")
    return report


def _decode_abort(store) -> Optional[object]:
    """The job-wide abort flag, parsed (None when unset) — piggybacked
    on health-renewal and /batch replies so one round trip answers both
    "lease renewed" and "is the job aborting"."""
    raw = store.get(f"/{ABORT_SCOPE}/{ABORT_KEY}")
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return {"reason": "<undecodable abort flag>"}


def _epoch_of(value: bytes) -> Optional[int]:
    try:
        rec = json.loads(value)
        return int(rec.get("epoch"))
    except (ValueError, TypeError, AttributeError):
        return None


def apply_put(httpd, path: str, value: bytes) -> None:
    """One KV write — the single choke point shared by ``do_PUT``,
    ``PUT /batch``, and the in-process :meth:`RendezvousServer.put`:
    fences ``/membership/epoch`` regressions (:class:`EpochFencedError`)
    and stamps health leases on the server's clock."""
    store = httpd.store
    if path == EPOCH_PATH:
        # check-then-put under one lock: two concurrent writers (the
        # live driver and a partitioned stale one — the very race the
        # fence exists for) must serialize, or both could pass the
        # check against the same committed epoch
        with httpd.fence_lock:
            new = _epoch_of(value)
            cur_raw = store.get(EPOCH_PATH)
            if cur_raw is not None:
                cur = _epoch_of(cur_raw)
                if cur is not None and (new is None or new < cur):
                    raise EpochFencedError(
                        f"membership epoch write ({new}) does not advance "
                        f"the committed epoch ({cur}); rejected by the "
                        "split-brain fence")
            store.put(path, value)
        return
    store.put(path, value)
    if path.startswith(_HEALTH_PREFIX):
        # the lease stamp: receipt on the SERVER clock, so age /
        # expiry never depend on worker clocks (GET /health)
        with httpd.lock:
            httpd.lease_times[path] = time.monotonic()


class _DeltaResync(Exception):
    """A metrics delta PUT cannot be merged (unknown base incarnation
    or no stored snapshot): the pusher must resend a full snapshot."""


def _parse_metrics_delta(body: bytes) -> Optional[dict]:
    """Decode a metrics-scope PUT body as a delta payload, or None for
    a plain full snapshot.  Deltas are written with ``__delta__`` as
    the first key (metrics/push.py), so the cheap prefix check keeps
    full-snapshot PUTs off the JSON parser twice."""
    if b'"__delta__"' not in body[:32]:
        return None
    try:
        payload = json.loads(body)
    except (ValueError, TypeError):
        return None
    if isinstance(payload, dict) and payload.get("__delta__"):
        return payload
    return None


def _merge_metrics_delta(store, path: str, delta: dict,
                         server_id: str) -> bytes:
    """Merge a delta push into the stored full snapshot; raises
    :class:`_DeltaResync` when the delta's base incarnation is not this
    server (restart/failover) or there is nothing to merge into."""
    if delta.get("base_id") != server_id:
        raise _DeltaResync()
    cur_raw = store.get(path)
    if cur_raw is None:
        raise _DeltaResync()
    try:
        cur = json.loads(cur_raw)
    except (ValueError, TypeError):
        raise _DeltaResync()
    fams = cur.get("metrics")
    if not isinstance(fams, dict):
        raise _DeltaResync()
    changed = delta.get("metrics")
    if isinstance(changed, dict):
        fams.update(changed)
    for name in delta.get("removed") or ():
        fams.pop(name, None)
    cur["ts"] = delta.get("ts", time.time())
    return json.dumps(cur).encode()


def _parse_ts_delta(body: bytes) -> Optional[dict]:
    """Decode a timeseries-scope PUT body as an append-delta payload,
    or None for a full snapshot.  Same cheap-prefix contract as
    :func:`_parse_metrics_delta` (``__tsdelta__`` is written first,
    metrics/timeseries.py)."""
    if b'"__tsdelta__"' not in body[:32]:
        return None
    try:
        payload = json.loads(body)
    except (ValueError, TypeError):
        return None
    if isinstance(payload, dict) and payload.get("__tsdelta__"):
        return payload
    return None


def _merge_ts_delta(store, path: str, delta: dict,
                    server_id: str) -> bytes:
    """Append a timeseries delta into the stored per-rank document;
    raises :class:`_DeltaResync` when the delta's base incarnation is
    not this server or there is nothing to append into.  Each series is
    trimmed to ``HVD_TIMESERIES_SERVER_CAP`` samples — the server-side
    bound that keeps an always-on history from growing a per-rank doc
    without limit."""
    from ..utils import env as env_util

    if delta.get("base_id") != server_id:
        raise _DeltaResync()
    cur_raw = store.get(path)
    if cur_raw is None:
        raise _DeltaResync()
    try:
        cur = json.loads(cur_raw)
    except (ValueError, TypeError):
        raise _DeltaResync()
    series = cur.get("series")
    if not isinstance(series, dict):
        raise _DeltaResync()
    cap = env_util.get_int(env_util.HVD_TIMESERIES_SERVER_CAP,
                           env_util.DEFAULT_TIMESERIES_SERVER_CAP)
    for name, entry in (delta.get("series") or {}).items():
        if not isinstance(entry, dict):
            continue
        dst = series.setdefault(name, {"samples": []})
        samples = dst.get("samples")
        if not isinstance(samples, list):
            samples = dst["samples"] = []
        new = [s for s in entry.get("samples") or ()
               if isinstance(s, (list, tuple)) and len(s) == 2]
        samples.extend([list(s) for s in new])
        if len(samples) > cap:
            del samples[:len(samples) - cap]
        dst["seq"] = entry.get("seq", dst.get("seq"))
        if entry.get("dropped"):
            dst["dropped"] = dst.get("dropped", 0) + int(entry["dropped"])
        if new:
            dst["last_step"] = new[-1][0]
    cur["ts"] = time.time()
    return json.dumps(cur).encode()


class KVStoreHandler(BaseHTTPRequestHandler):
    """GET /scope/key → 200 bytes | 404; PUT stores; DELETE /scope
    finalizes the scope (rendezvous complete)."""

    protocol_version = "HTTP/1.1"
    # reap idle keep-alive connections (run/http_client.py pools one
    # connection per client thread) instead of holding a server thread
    # per dead client forever
    timeout = 65
    # small replies written in several send() calls + Nagle + the
    # client's delayed ACK = ~40 ms per exchange on a keep-alive
    # connection; the control plane lives on small exchanges
    disable_nagle_algorithm = True

    def _count(self) -> None:
        if getattr(self.server, "rdv_dead", False):
            # stop() ran but this keep-alive connection's handler thread
            # is still alive: a stopped server must look DEAD to pooled
            # clients (connection aborted → their failover path), not
            # like a live store serving a stale world
            raise ConnectionAbortedError("rendezvous server stopped")
        with self.server.count_lock:  # type: ignore[attr-defined]
            self.server.requests_served += 1  # type: ignore[attr-defined]

    def _verify(self, body: bytes = b"") -> bool:
        secret = self.server.secret  # type: ignore[attr-defined]
        if secret is None:
            return True
        got = self.headers.get(SECRET_HEADER, "")
        want = sign(secret, self.path, body)
        return hmac.compare_digest(got, want)

    def _reply(self, code: int, body: bytes = b"",
               content_type: Optional[str] = None) -> None:
        self.send_response(code)
        if content_type:
            self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _rank_snapshots(self):
        """(extra_labels, snapshot) per pushed rank, rank-ordered, plus
        the launcher's own in-process registry last."""
        from ..metrics.registry import registry

        store: ShardedKVStore = self.server.store  # type: ignore
        pushed = {k[len(_METRICS_PREFIX):]: v
                  for k, v in store.prefix_items(_METRICS_PREFIX).items()}
        snaps = []
        for rank in sorted(pushed, key=lambda r: (not r.isdigit(), int(r)
                                                  if r.isdigit() else 0, r)):
            try:
                snaps.append(({"rank": rank}, json.loads(pushed[rank])))
            except (ValueError, TypeError):
                log.warning("metrics: undecodable snapshot from rank %s",
                            rank)
        snaps.append(({"rank": "launcher"}, registry.snapshot()))
        return snaps

    def _sanitizer_table(self) -> Dict[str, Dict[str, Dict[str, object]]]:
        """Published collective fingerprints partitioned by communication
        group, then ``<epoch>.<seq>``, then rank:
        ``{"world": {"0.5": {"0": {...}, "1": {...}}}}`` — the live view
        of which rank is ahead/behind *within each group* when the
        sanitizer (or an operator) is chasing a divergence.  Keys are
        ``<group>.<epoch>.<seq>.<rank>`` (analysis/sanitizer.py); legacy
        two-part ``<seq>.<rank>`` keys render under ``world`` epoch 0."""
        store: ShardedKVStore = self.server.store  # type: ignore
        raw = {k[len(_SANITIZER_PREFIX):]: v
               for k, v in store.prefix_items(_SANITIZER_PREFIX).items()}
        table: Dict[str, Dict[str, Dict[str, object]]] = {}
        for key, val in raw.items():
            parts = key.split(".")
            if len(parts) == 4:
                group, epoch, seq, rank = parts
            elif len(parts) == 2:
                group, epoch = "world", "0"
                seq, rank = parts
            else:
                continue
            try:
                decoded: object = json.loads(val)
            except (ValueError, TypeError):
                decoded = "<undecodable>"
            table.setdefault(group, {}).setdefault(
                f"{epoch}.{seq}", {})[rank] = decoded
        return table

    def _health_report(self) -> Dict[str, object]:
        """Per-rank lease ages and verdicts plus the abort flag, so one
        GET answers both "who is alive" and "is the job aborting"."""
        with self.server.lock:  # type: ignore
            lease_times = dict(self.server.lease_times)  # type: ignore
        return build_health_report(
            self.server.store.items(), lease_times)  # type: ignore

    def do_GET(self) -> None:  # noqa: N802
        self._count()
        if not self._verify():
            self._reply(401)
            return
        path, _, query = self.path.partition("?")
        path = path.rstrip("/")
        if path.startswith(SCOPE_ROUTE_PREFIX) and "since=" in query:
            # scope-level batch read with a change cursor: GET
            # /scope/<name>?since=V (docs/control_plane.md).  The
            # ``since`` parameter is what selects this route — clients
            # always send one (-1 = full) — so a plain GET of a KV key
            # under a scope literally named "scope" still works.
            from urllib.parse import parse_qs

            scope = path[len(SCOPE_ROUTE_PREFIX):]
            since = None
            vals = parse_qs(query).get("since")
            if vals:
                try:
                    since = int(vals[0])
                except ValueError:
                    since = None
            res = self.server.store.scope_since(scope, since)  # type: ignore
            body = json.dumps({
                "server_id": self.server.server_id,  # type: ignore
                "version": res["version"],
                "full": res["full"],
                "entries": {k: b64encode(v).decode()
                            for k, v in res["entries"].items()},
                "removed": res["removed"],
            }).encode()
            self._reply(200, body, content_type="application/json")
            return
        if path == "/health":
            self._reply(200, json.dumps(self._health_report()).encode(),
                        content_type="application/json")
            return
        if path == "/membership":
            store = self.server.store.items()  # type: ignore
            self._reply(200, json.dumps(build_membership_report(store))
                        .encode(), content_type="application/json")
            return
        if path == "/peerstate":
            store = self.server.store.items()  # type: ignore
            self._reply(200, json.dumps(build_peerstate_report(store))
                        .encode(), content_type="application/json")
            return
        if path == "/serving":
            frontend = getattr(self.server, "serving_frontend", None)
            if frontend is None:
                self._reply(404)
                return
            try:
                body = json.dumps(frontend.report()).encode()
            except Exception as e:  # noqa: BLE001 — status page must
                body = json.dumps(  # not 500 the whole server
                    {"error": f"{type(e).__name__}: {e}"}).encode()
            self._reply(200, body, content_type="application/json")
            return
        # Aggregated metrics routes.  No key collision with the KV store:
        # stored keys are always two-part /scope/key paths.
        if path == "/metrics":
            from ..metrics.registry import render_prometheus

            body = render_prometheus(self._rank_snapshots()).encode()
            self._reply(200, body,
                        content_type="text/plain; version=0.0.4")
            return
        if path == "/metrics.json":
            merged = {labels["rank"]: snap
                      for labels, snap in self._rank_snapshots()}
            self._reply(200, json.dumps(merged).encode(),
                        content_type="application/json")
            return
        if path == "/sanitizer":
            self._reply(200, json.dumps(self._sanitizer_table()).encode(),
                        content_type="application/json")
            return
        if path == "/clock":
            # one leg of the NTP-style offset handshake
            # (timeline/replay/clock.py): the server's monotonic clock in
            # µs — only server-relative consistency matters, every rank
            # estimates its offset against this same process clock
            body = json.dumps({"server_us": time.perf_counter() * 1e6})
            self._reply(200, body.encode(),
                        content_type="application/json")
            return
        if path == "/replay":
            val = self.server.store.get(  # type: ignore
                f"/{REPLAY_SCOPE}/{REPLAY_SUMMARY_KEY}")
            if val is None:
                self._reply(404)
            else:
                self._reply(200, val, content_type="application/json")
            return
        if path == "/projection":
            val = self.server.store.get(  # type: ignore
                f"/{PROJECTION_SCOPE}/{PROJECTION_SUMMARY_KEY}")
            if val is None:
                self._reply(404)
            else:
                self._reply(200, val, content_type="application/json")
            return
        if path == "/autotune":
            store = self.server.store.items()  # type: ignore
            self._reply(200, json.dumps(build_autotune_report(store))
                        .encode(), content_type="application/json")
            return
        if path == "/profile":
            store = self.server.store.items()  # type: ignore
            self._reply(200, json.dumps(build_profile_report(store))
                        .encode(), content_type="application/json")
            return
        if path == "/timeseries":
            store = self.server.store.items()  # type: ignore
            self._reply(200, json.dumps(build_timeseries_report(store))
                        .encode(), content_type="application/json")
            return
        if path == "/alerts":
            store = self.server.store.items()  # type: ignore
            report = build_alerts_report(store)
            # the report carries the incarnation id so a following
            # console (hvd_watch --follow) can tell a restarted server
            # from a quiet one instead of re-printing old alerts
            report["server_id"] = self.server.server_id  # type: ignore
            self._reply(200, json.dumps(report).encode(),
                        content_type="application/json")
            return
        if path == "/events":
            from urllib.parse import parse_qs

            qs = parse_qs(query)
            since_ts = None
            vals = qs.get("since_ts")
            if vals:
                try:
                    since_ts = float(vals[0])
                except ValueError:
                    since_ts = None
            kind = (qs.get("kind") or [None])[0]
            store = self.server.store.items()  # type: ignore
            report = build_events_report(store, since_ts=since_ts,
                                         kind=kind)
            report["server_id"] = self.server.server_id  # type: ignore
            report["version"] = \
                self.server.store.scope_since(  # type: ignore
                    EVENTS_SCOPE, None)["version"]
            self._reply(200, json.dumps(report).encode(),
                        content_type="application/json")
            return
        val = self.server.store.get(self.path)  # type: ignore
        if val is None:
            self._reply(404)
        else:
            self._reply(200, val)

    def do_POST(self) -> None:  # noqa: N802
        """Serving-plane routes (serving/frontend.py, ROADMAP item 14): the
        KV store itself has no POST surface, so every POST belongs to
        the attached ServingFrontend — 503 when none is attached (the
        job was not launched with ``--serve``; the reply's text is the
        reference's, byte for byte)."""
        self._count()
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._verify(body):
            self._reply(401)
            return
        frontend = getattr(self.server, "serving_frontend", None)
        path = self.path.rstrip("/")
        routes = {} if frontend is None else {
            "/infer": frontend.handle_infer,
            "/serving/pull": frontend.handle_pull,
            "/serving/result": frontend.handle_result,
        }
        handler = routes.get(path)
        if handler is None:
            if path in ("/infer", "/serving/pull", "/serving/result"):
                self._reply(503, json.dumps(
                    {"error": "no serving plane attached (launch with "
                              "tpurun --serve)"}).encode(),
                    content_type="application/json")
            else:
                self._reply(404)
            return
        try:
            payload = json.loads(body) if body else {}
        except ValueError as e:
            self._reply(400, json.dumps(
                {"error": f"undecodable JSON body: {e}"}).encode(),
                content_type="application/json")
            return
        try:
            code, reply = handler(payload)
        except Exception as e:  # noqa: BLE001 — a handler bug must not
            code, reply = 500, {  # tear down the rendezvous server
                "error": f"{type(e).__name__}: {e}"}
            log.exception("serving route %s failed", path)
        self._reply(code, json.dumps(reply).encode(),
                    content_type="application/json")

    def do_PUT(self) -> None:  # noqa: N802
        self._count()
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._verify(body):
            self._reply(401)
            return
        if self.path == BATCH_PATH:
            self._handle_batch(body)
            return
        try:
            reply = self._apply_one(self.path, body)
        except EpochFencedError as e:
            self._reply(409, json.dumps({"error": str(e)}).encode(),
                        content_type="application/json")
            return
        except _DeltaResync:
            self._reply(409, json.dumps({
                "server_id": self.server.server_id,  # type: ignore
                "resync": True}).encode(),
                content_type="application/json")
            return
        if reply is None:
            self._reply(200)
        else:
            self._reply(200, json.dumps(reply).encode(),
                        content_type="application/json")

    def _apply_one(self, path: str, body: bytes) -> Optional[dict]:
        """Store one PUT.  Health renewals answer with the abort
        verdict (the heartbeat's batched round trip); metrics PUTs may
        be delta payloads merged server-side; both reply the
        ``server_id`` so clients detect failovers."""
        httpd = self.server
        if path.startswith(_METRICS_PREFIX):
            delta = _parse_metrics_delta(body)
            if delta is not None:
                body = _merge_metrics_delta(
                    httpd.store, path, delta,  # type: ignore
                    httpd.server_id)  # type: ignore[attr-defined]
            apply_put(httpd, path, body)
            return {"server_id": httpd.server_id}  # type: ignore
        if path.startswith(_TIMESERIES_PREFIX):
            delta = _parse_ts_delta(body)
            if delta is not None:
                body = _merge_ts_delta(
                    httpd.store, path, delta,  # type: ignore
                    httpd.server_id)  # type: ignore[attr-defined]
            apply_put(httpd, path, body)
            return {"server_id": httpd.server_id}  # type: ignore
        apply_put(httpd, path, body)
        if path.startswith(_HEALTH_PREFIX):
            return {"server_id": httpd.server_id,  # type: ignore
                    "abort": _decode_abort(httpd.store)}  # type: ignore
        return None

    def _handle_batch(self, body: bytes) -> None:
        """``PUT /batch``: apply many KV entries in one signed request
        (the relay tree's upstream leg).  Undecodable entries are
        counted and skipped; a fenced epoch write rejects the batch."""
        try:
            payload = json.loads(body)
        except ValueError as e:
            self._reply(400, json.dumps(
                {"error": f"undecodable batch body: {e}"}).encode(),
                content_type="application/json")
            return
        applied = skipped = 0
        try:
            for entry in payload.get("entries") or ():
                path = entry.get("p") if isinstance(entry, dict) else None
                if not isinstance(path, str) or not path.startswith("/"):
                    skipped += 1
                    continue
                try:
                    value = b64decode(entry.get("v") or "")
                except (ValueError, TypeError):
                    skipped += 1
                    continue
                apply_put(self.server, path, value)
                applied += 1
        except EpochFencedError as e:
            self._reply(409, json.dumps({"error": str(e)}).encode(),
                        content_type="application/json")
            return
        self._reply(200, json.dumps({
            "server_id": self.server.server_id,  # type: ignore
            "abort": _decode_abort(self.server.store),  # type: ignore
            "applied": applied,
            "skipped": skipped,
        }).encode(), content_type="application/json")

    def do_DELETE(self) -> None:  # noqa: N802
        self._count()
        if not self._verify():
            self._reply(401)
            return
        deleted = self.server.store.delete_matching(self.path)  # type: ignore
        with self.server.lock:  # type: ignore
            for k in deleted:
                self.server.lease_times.pop(k, None)  # type: ignore
            # only whole-scope deletes mark rendezvous finalization;
            # per-key deletes (sanitizer fingerprint GC) must not grow
            # this set one entry per dispatch
            if self.path.rstrip("/").count("/") == 1:
                self.server.finalized.add(self.path)  # type: ignore
        self._reply(200)

    def log_message(self, fmt, *args):  # silence default stderr spam
        log.debug("kvstore: " + fmt, *args)


class QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that does not print tracebacks for expected
    connection teardowns: a stopped server aborting its keep-alive
    connections (``rdv_dead``) and clients hanging up mid-request."""

    def handle_error(self, request, client_address):  # noqa: D102
        import sys as _sys

        exc = _sys.exc_info()[1]
        if isinstance(exc, (ConnectionAbortedError, ConnectionResetError,
                            BrokenPipeError)):
            return
        super().handle_error(request, client_address)


class RendezvousServer:
    """Threaded KV server owned by the launcher (reference
    run/http/http_server.py RendezvousServer; started by gloo_run at
    reference run/gloo_run.py:268-272)."""

    def __init__(self, secret: Optional[bytes] = None, port: int = 0,
                 journal_path: Optional[str] = None,
                 shards: Optional[int] = None):
        self._httpd = QuietThreadingHTTPServer(("0.0.0.0", port),
                                               KVStoreHandler)
        store = ShardedKVStore(shards=shards)
        journal = None
        if journal_path:
            import os as _os

            from .journal import Journal, replay

            # recovery BEFORE journaling resumes: a restarted primary
            # picks its state (and, critically, the committed epoch the
            # fence compares against) back up from its own journal
            # instead of starting empty — without re-journaling the
            # replayed records
            if _os.path.exists(journal_path):
                n = replay(journal_path, store)
                if n:
                    log.info("rendezvous: recovered %d journal records "
                             "from %s", n, journal_path)
            journal = Journal(journal_path)
            store.journal = journal
        self._journal = journal
        self._httpd.store = store  # type: ignore[attr-defined]
        # guards the non-sharded side state: lease_times + finalized
        self._httpd.lock = threading.Lock()  # type: ignore[attr-defined]
        self._httpd.secret = secret  # type: ignore[attr-defined]
        self._httpd.finalized = set()  # type: ignore[attr-defined]
        self._httpd.lease_times = {}  # type: ignore[attr-defined]
        self._httpd.serving_frontend = None  # type: ignore[attr-defined]
        # per-incarnation identity: clients detect a restart/failover by
        # the server_id changing in mutating replies and scope reads
        self._httpd.server_id = uuid.uuid4().hex  # type: ignore
        self._httpd.requests_served = 0  # type: ignore[attr-defined]
        self._httpd.count_lock = threading.Lock()  # type: ignore
        # serializes the /membership/epoch check-then-put (apply_put)
        self._httpd.fence_lock = threading.Lock()  # type: ignore
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def store(self) -> ShardedKVStore:
        return self._httpd.store  # type: ignore[attr-defined]

    @property
    def server_id(self) -> str:
        return self._httpd.server_id  # type: ignore[attr-defined]

    @property
    def requests_served(self) -> int:
        """Total HTTP requests handled (the churn benchmark's
        request-rate instrument, scripts/control_plane_bench.py)."""
        return self._httpd.requests_served  # type: ignore[attr-defined]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="hvd-rendezvous",
        )
        self._thread.start()
        log.debug("rendezvous server on port %d", self.port)
        return self.port

    def stop(self) -> None:
        self._httpd.rdv_dead = True  # type: ignore[attr-defined]
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        # release the port: pooled keep-alive clients must see a dead
        # primary as connection-refused, not a silent accept-less bind
        self._httpd.server_close()
        if self._journal is not None:
            self._journal.close()

    # direct (in-process) access for the launcher itself
    def get(self, scope: str, key: str) -> Optional[bytes]:
        return self.store.get(f"/{scope}/{key}")

    def put(self, scope: str, key: str, value: bytes) -> None:
        """One in-process write, through the same fence/journal/lease
        choke point as the HTTP surface (raises
        :class:`EpochFencedError` on a regressed epoch commit)."""
        apply_put(self._httpd, f"/{scope}/{key}", value)

    def delete(self, scope: str, key: str) -> None:
        """Drop one key (e.g. the elastic driver revoking a dead rank's
        /health lease)."""
        path = f"/{scope}/{key}"
        self.store.pop(path)
        with self._httpd.lock:  # type: ignore[attr-defined]
            self._httpd.lease_times.pop(path, None)  # type: ignore

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        """Snapshot of every key under ``scope`` (key names without the
        scope prefix) — the elastic driver's poll of announces/acks."""
        prefix = f"/{scope}/"
        return {k[len(prefix):]: v
                for k, v in self.store.prefix_items(prefix).items()}

    def scope_since(self, scope: str,
                    since: Optional[int] = None) -> Dict[str, object]:
        """In-process equivalent of ``GET /scope/<name>?since=V``."""
        return self.store.scope_since(scope, since)

    def health_report(self) -> Dict[str, object]:
        """In-process equivalent of GET /health (the elastic driver polls
        lease verdicts without going through its own HTTP stack)."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            lease_times = dict(self._httpd.lease_times)  # type: ignore
        return build_health_report(self.store.items(), lease_times)

    def membership_report(self) -> Dict[str, object]:
        """In-process equivalent of GET /membership."""
        return build_membership_report(self.store.items())

    def autotune_report(self) -> Dict[str, object]:
        """In-process equivalent of GET /autotune."""
        return build_autotune_report(self.store.items())

    def profile_report(self) -> Dict[str, object]:
        """In-process equivalent of GET /profile."""
        return build_profile_report(self.store.items())

    def timeseries_report(self) -> Dict[str, object]:
        """In-process equivalent of GET /timeseries (the watchdog's
        per-tick read when it runs next to this server)."""
        return build_timeseries_report(self.store.items())

    def alerts_report(self) -> Dict[str, object]:
        """In-process equivalent of GET /alerts."""
        return build_alerts_report(self.store.items())

    def events_report(self, since_ts: Optional[float] = None,
                      kind: Optional[str] = None) -> Dict[str, object]:
        """In-process equivalent of GET /events (the flight-recorder
        log, oldest first — observe/events.py)."""
        return build_events_report(self.store.items(), since_ts=since_ts,
                                   kind=kind)

    def projection_report(self) -> Optional[Dict[str, object]]:
        """In-process equivalent of GET /projection (None when no
        projection summary has been pushed)."""
        raw = self.get(PROJECTION_SCOPE, PROJECTION_SUMMARY_KEY)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except (ValueError, TypeError):
            return {"error": "<undecodable projection summary>"}

    def attach_serving(self, frontend) -> None:
        """Attach a serving front-end (serving/frontend.py): POST
        /infer, POST /serving/pull|result, and GET /serving route to it
        from then on.  ``None`` detaches."""
        self._httpd.serving_frontend = frontend  # type: ignore

    def serving_report(self) -> Optional[Dict[str, object]]:
        """In-process equivalent of GET /serving (None when no serving
        plane is attached)."""
        frontend = getattr(self._httpd, "serving_frontend", None)
        return None if frontend is None else frontend.report()

    def clear_scope(self, scope: str) -> None:
        """Drop every key under ``scope`` (the supervisor resets the
        ``abort``/``health`` scopes between restart attempts so a stale
        flag cannot abort the fresh incarnation)."""
        prefix = f"/{scope}/"
        self.store.clear_scope(scope)
        with self._httpd.lock:  # type: ignore[attr-defined]
            lease_times = self._httpd.lease_times  # type: ignore
            for k in [k for k in lease_times if k.startswith(prefix)]:
                del lease_times[k]


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]
