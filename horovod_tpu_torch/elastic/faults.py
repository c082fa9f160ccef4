"""Fault-injection harness: drive detect→abort→restart→resume on purpose
(the port of ``horovod_tpu/elastic/faults.py``; the grammar, the seams
and the seeded draws are the reference's, so one ``HVD_FAULT_SPEC``
fires the same faults in either package).

A fault-tolerance path that only runs when hardware actually dies is an
untested path.  ``HVD_FAULT_SPEC`` injects failures at three seams so
tests exercise the full failure-domain loop deterministically:

* **step** — the train step's wrapper (training.py, beside the abort
  check) and any loop that calls :func:`on_step` directly;
* **dispatch** — every guarded host collective (eager._host_guard);
* **http** — the rendezvous HTTP client (run/http_client.py), to
  exercise its retry/backoff path;
* **controller** — the eager-plane negotiation handshake
  (runtime/eager_controller.negotiate);
* **peer_push** / **peer_pull** — the peer state plane's shard upload
  and restore reads (elastic/peerstate.py).  ``peer_push`` is a
  *mutating* seam: a ``corrupt`` fault flips bytes in the shard on its
  way to the replica, so the checksum-reject → storage-fallback path is
  drivable end to end; ``peer_pull`` fires before each shard fetch, so
  ``http_drop`` / ``partition`` there model a peer dying mid-restore.

Grammar (specs separated by ``;``, fields by ``:``, ``key=value``)::

    HVD_FAULT_SPEC="rank=1:step=3:kind=crash"
    HVD_FAULT_SPEC="rank=*:kind=slow=200ms:prob=0.5;rank=0:step=10:kind=hang"
    HVD_FAULT_SPEC="kind=http_drop:prob=0.3:restart=*"
    HVD_FAULT_SPEC="rank=1:step=4:kind=partition"
    HVD_FAULT_SPEC="kind=corrupt:seam=peer_push:restart=*"
    HVD_FAULT_SPEC="kind=http_drop:seam=peer_pull:restart=*"

Fields:

``rank``     int or ``*`` (default ``*``): the HVD_PROCESS_ID it fires on.
``step``     int or ``*`` (default ``*``): the 0-based invocation counter
             of the seam in this process (each seam counts separately).
``kind``     ``crash`` (``os._exit(17)`` — a sudden worker death),
             ``hang`` (sleep forever, the wedged-collective shape),
             ``slow=<dur>`` (inject ``<dur>`` latency, e.g. ``200ms`` /
             ``1.5s``, then continue), ``http_drop`` (raise
             ``URLError`` from the HTTP client), ``partition`` (a
             network split: from the firing point on, EVERY rendezvous
             HTTP request raises ``URLError`` and every controller
             negotiation raises ``TimeoutError``, while the process
             itself stays alive — heartbeat leases expire and the
             elastic driver removes the rank without a process death),
             ``corrupt`` (flip bytes in the payload at a mutating
             seam — only ``peer_push`` today; elsewhere it is a no-op),
             or ``preempt[=<grace>]`` (deliver a grace-window
             preemption notice: the worker publishes
             ``membership/preempt.<worker>`` and keeps training; the
             elastic driver's poll turns the notice into a planned
             drain+snapshot — elastic/driver.preempt — instead of a
             crash.  Fires at most once per process).
``prob``     float in [0, 1] (default 1.0).
``seam``     ``step`` / ``dispatch`` / ``http`` / ``controller`` /
             ``peer_push`` / ``peer_pull``; defaults to ``http`` for
             ``http_drop``, ``peer_push`` for ``corrupt``, and ``step``
             otherwise.
``restart``  int or ``*`` (default 0): the ``HVD_RESTART_COUNT``
             incarnation the fault applies to.  The default means a
             crash fires on the first run only, so a supervised restart
             (``--restarts``) relaunches into a clean incarnation.
"""

from __future__ import annotations

import os
import random
import re
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

#: exit code of an injected ``crash`` — distinguishable from real failures
#: in launcher logs and test assertions.
FAULT_EXIT_CODE = 17

KINDS = ("crash", "hang", "slow", "http_drop", "partition", "corrupt",
         "preempt")
SEAMS = ("step", "dispatch", "http", "controller", "peer_push",
         "peer_pull")

_DURATION = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m)?$")
_DUR_SCALE = {"ms": 1e-3, "s": 1.0, "m": 60.0, None: 1.0}


class FaultSpecError(ValueError):
    """``HVD_FAULT_SPEC`` did not parse; the message pins the bad field."""


@dataclass(frozen=True)
class Fault:
    kind: str
    seam: str
    rank: Optional[int] = None      # None = any rank
    step: Optional[int] = None      # None = every invocation
    restart: Optional[int] = 0      # None = every incarnation
    prob: float = 1.0
    duration: float = 0.0           # slow: injected latency, seconds


def parse_duration(text: str) -> float:
    m = _DURATION.match(text.strip())
    if not m:
        raise FaultSpecError(f"bad duration {text!r} (want e.g. 200ms, 1.5s)")
    return float(m.group(1)) * _DUR_SCALE[m.group(2)]


def _int_or_any(value: str, field: str) -> Optional[int]:
    if value == "*":
        return None
    try:
        return int(value)
    except ValueError:
        raise FaultSpecError(f"bad {field}={value!r} (want an int or '*')")


def parse_spec(text: str) -> List[Fault]:
    """Parse one ``HVD_FAULT_SPEC`` value into its fault list."""
    faults: List[Fault] = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        fields = {}
        for field in chunk.split(":"):
            key, sep, value = field.partition("=")
            key = key.strip()
            if not sep or not key:
                raise FaultSpecError(
                    f"bad field {field!r} in {chunk!r} (want key=value)")
            fields[key] = value.strip()
        unknown = set(fields) - {"rank", "step", "kind", "prob", "seam",
                                 "restart"}
        if unknown:
            raise FaultSpecError(
                f"unknown field(s) {sorted(unknown)} in {chunk!r}")
        if "kind" not in fields:
            raise FaultSpecError(f"missing kind= in {chunk!r}")
        kind, _, arg = fields["kind"].partition("=")
        if kind not in KINDS:
            raise FaultSpecError(
                f"unknown kind {kind!r} in {chunk!r} (want one of {KINDS})")
        duration = 0.0
        if kind == "slow":
            if not arg:
                raise FaultSpecError(
                    f"kind=slow needs a duration (slow=200ms) in {chunk!r}")
            duration = parse_duration(arg)
        elif kind == "preempt":
            # optional grace window: preempt=30s; 0 means "driver default"
            duration = parse_duration(arg) if arg else 0.0
        elif arg:
            raise FaultSpecError(
                f"kind={kind} takes no argument (got {arg!r}) in {chunk!r}")
        default_seam = {"http_drop": "http",
                        "corrupt": "peer_push"}.get(kind, "step")
        seam = fields.get("seam", default_seam)
        if seam not in SEAMS:
            raise FaultSpecError(
                f"unknown seam {seam!r} in {chunk!r} (want one of {SEAMS})")
        prob = float(fields.get("prob", 1.0))
        if not 0.0 <= prob <= 1.0:
            raise FaultSpecError(f"prob={prob} out of [0, 1] in {chunk!r}")
        faults.append(Fault(
            kind=kind, seam=seam,
            rank=_int_or_any(fields.get("rank", "*"), "rank"),
            step=_int_or_any(fields.get("step", "*"), "step"),
            restart=_int_or_any(fields.get("restart", "0"), "restart"),
            prob=prob, duration=duration,
        ))
    return faults


class FaultInjector:
    """One process's armed fault set.  Each seam keeps its own 0-based
    invocation counter; a matching fault acts when the counter, rank,
    incarnation, and probability all line up."""

    def __init__(self, faults: List[Fault], rank: int, restart: int,
                 seed: Optional[int] = None):
        self.faults = list(faults)
        self.rank = int(rank)
        self.restart = int(restart)
        self._counts = {seam: 0 for seam in SEAMS}
        self._lock = threading.Lock()
        # probabilistic faults draw from a PER-INJECTOR stream: with
        # HVD_FAULT_SEED set, the seed is mixed with rank + incarnation
        # so every process draws a distinct but replayable sequence —
        # a failing prob= chaos run reproduces under the same seed
        if seed is None:
            self._rng = random.Random()
        else:
            self._rng = random.Random(
                (int(seed) * 0x9E3779B1
                 + self.rank * 0x85EBCA6B
                 + self.restart * 0xC2B2AE35) & 0xFFFFFFFF)
        # once a `partition` fault fires, this process's rendezvous +
        # controller traffic is dropped for good (the network-split shape)
        self.partitioned = False
        # a `preempt` fault delivers its notice at most once
        self.preempted = False

    def fire(self, seam: str, detail: str = "") -> None:
        with self._lock:
            n = self._counts[seam]
            self._counts[seam] = n + 1
        for f in self.faults:
            if f.seam != seam:
                continue
            if f.rank is not None and f.rank != self.rank:
                continue
            if f.restart is not None and f.restart != self.restart:
                continue
            if f.step is not None and f.step != n:
                continue
            if f.prob < 1.0 and self._rng.random() >= f.prob:
                continue
            self._act(f, seam, n, detail)

    def mutate(self, seam: str, data: bytes) -> bytes:
        """The mutating variant of :meth:`fire` for seams that carry a
        payload (``peer_push``): a matching ``corrupt`` fault flips
        bytes in ``data``; any other matching kind acts as usual.  The
        seam's invocation counter advances exactly once per call."""
        with self._lock:
            n = self._counts[seam]
            self._counts[seam] = n + 1
        for f in self.faults:
            if f.seam != seam:
                continue
            if f.rank is not None and f.rank != self.rank:
                continue
            if f.restart is not None and f.restart != self.restart:
                continue
            if f.step is not None and f.step != n:
                continue
            if f.prob < 1.0 and self._rng.random() >= f.prob:
                continue
            if f.kind == "corrupt":
                from .. import metrics

                if metrics.on():
                    metrics.FAULTS_INJECTED.labels(f.kind).inc()
                log.warning(
                    "fault injection: corrupt at %s[%d] rank=%d "
                    "restart=%d (%d bytes)", seam, n, self.rank,
                    self.restart, len(data))
                data = _flip_bytes(data)
            else:
                self._act(f, seam, n, f"{len(data)}B")
        return data

    def _act(self, f: Fault, seam: str, n: int, detail: str) -> None:
        from .. import metrics

        if metrics.on():
            metrics.FAULTS_INJECTED.labels(f.kind).inc()
        log.warning("fault injection: %s at %s[%d] rank=%d restart=%d %s",
                    f.kind, seam, n, self.rank, self.restart, detail)
        if f.kind == "crash":
            os._exit(FAULT_EXIT_CODE)
        elif f.kind == "hang":
            while True:  # the wedged-worker shape: only a signal ends it
                time.sleep(3600)
        elif f.kind == "slow":
            time.sleep(f.duration)
        elif f.kind == "partition":
            self.partitioned = True
        elif f.kind == "http_drop":
            import urllib.error

            raise urllib.error.URLError(
                f"injected http_drop at {seam}[{n}] {detail}")
        elif f.kind == "preempt":
            self._deliver_preemption(f.duration)
        # `corrupt` outside a mutating seam has no payload to flip — the
        # log line above is its only effect

    def _deliver_preemption(self, grace: float) -> None:
        """Publish a one-shot preemption notice for this worker; the
        elastic driver handles it as a planned drain+snapshot
        (elastic/driver.preempt).  The process keeps training inside
        the grace window — preemption is NOT a crash."""
        if self.preempted:
            return
        self.preempted = True
        try:
            from . import membership

            membership.notify_preemption(grace or None)
        except Exception as e:  # noqa: BLE001 — a worker without
            # rendezvous wiring still marks itself preempted; the
            # notice simply cannot reach a driver
            log.warning("preemption notice could not be published: %s", e)


def _flip_bytes(data: bytes) -> bytes:
    """Deterministic corruption: XOR a stride of bytes so any CRC32
    content checksum rejects the shard (elastic/peerstate.py)."""
    if not data:
        return b"\xff"
    out = bytearray(data)
    stride = max(len(out) // 8, 1)
    for i in range(0, len(out), stride):
        out[i] ^= 0xFF
    return bytes(out)


# ---------------------------------------------------------------------------
# process-wide wiring (built lazily from HVD_FAULT_SPEC, like the sanitizer)
# ---------------------------------------------------------------------------
_UNSET = object()
_instance = _UNSET
_instance_lock = threading.Lock()


def _build_from_env() -> Optional[FaultInjector]:
    spec = env_util.get_str(env_util.HVD_FAULT_SPEC)
    if not spec:
        return None
    faults = parse_spec(spec)  # a malformed spec must fail loudly, not arm 0
    if not faults:
        return None
    rank = env_util.get_int(env_util.HVD_PROCESS_ID, 0)
    restart = env_util.get_int(env_util.HVD_RESTART_COUNT, 0)
    seed: Optional[int] = None
    seed_raw = env_util.get_str(env_util.HVD_FAULT_SEED)
    if seed_raw is not None:
        try:
            seed = int(seed_raw)
        except ValueError:
            raise FaultSpecError(
                f"bad {env_util.HVD_FAULT_SEED}={seed_raw!r} (want an int)")
    inj = FaultInjector(faults, rank, restart, seed=seed)
    log.warning("fault injection armed: %d fault(s) on rank %d "
                "(incarnation %d): %s", len(faults), rank, restart, spec)
    return inj


def instance() -> Optional[FaultInjector]:
    global _instance
    if _instance is _UNSET:
        with _instance_lock:
            if _instance is _UNSET:
                _instance = _build_from_env()
    return _instance


def reset() -> None:
    """Drop the cached injector (tests / re-init re-read the env)."""
    global _instance
    with _instance_lock:
        _instance = _UNSET


def on_step() -> None:
    """The train-step seam (training.py; callable from any train loop)."""
    inj = instance()
    if inj is not None:
        inj.fire("step")


def on_dispatch(name: str) -> None:
    """The eager-dispatch seam (eager._dispatch_guard)."""
    inj = instance()
    if inj is not None:
        inj.fire("dispatch", detail=name)


def on_http(path: str) -> None:
    """The HTTP-client seam (run/http_client._request).  A partitioned
    process drops every rendezvous request from the firing point on."""
    inj = instance()
    if inj is not None:
        inj.fire("http", detail=path)
        if inj.partitioned:
            import urllib.error

            raise urllib.error.URLError(
                f"injected partition: rendezvous traffic dropped ({path})")


def on_peer_push(data: bytes) -> bytes:
    """The shard-upload seam (elastic/peerstate.py snapshot push).  A
    ``corrupt`` fault returns flipped bytes — the replica lands with a
    checksum that can never verify, driving the checksum-reject →
    next-replica → storage-fallback chain in tier-1."""
    inj = instance()
    if inj is None:
        return data
    return inj.mutate("peer_push", data)


def on_peer_pull(key: str) -> None:
    """The shard-fetch seam (elastic/peerstate.py restore).  An
    ``http_drop`` or ``partition`` here is a peer dying mid-restore:
    the puller falls to the next replica, then to the storage tier."""
    inj = instance()
    if inj is not None:
        inj.fire("peer_pull", detail=key)
        if inj.partitioned:
            import urllib.error

            raise urllib.error.URLError(
                f"injected partition: peer shard traffic dropped ({key})")


def on_controller(name: str) -> None:
    """The controller-negotiation seam (runtime/eager_controller.
    negotiate).  A partitioned process's negotiations time out the way a
    real network split's would."""
    inj = instance()
    if inj is not None:
        inj.fire("controller", detail=name)
        if inj.partitioned:
            raise TimeoutError(
                f"injected partition: controller traffic dropped for "
                f"{name!r}")
