"""Peer ring data plane: scalable host collectives for the bindings —
the port of ``horovod_tpu/runtime/ring.py``.

The torch/TF/MXNet bindings move host-resident gradients; the reference
hands those to Gloo's ring allreduce (reference
horovod/common/ops/gloo_operations.cc:120-158) or NCCL.  This module is
the TPU-era equivalent over plain worker↔worker TCP (csrc/ring.cc):
bandwidth-optimal ring allreduce with flat per-rank wire volume, vs the
O(n·payload) coordinator star that remains the transport for small
control payloads.

Two pieces:

* :class:`Ring` — thin ctypes wrapper over the native ring (create /
  connect / allreduce / broadcast).  Establishment: every rank opens a
  listener, the listen addresses are allgathered over the coordinator
  star (tiny payload), then each rank dials its right neighbor.
* :class:`RingExecutor` — the ordering layer.  Ring transfers block both
  neighbors, so every rank must run them in ONE global order even though
  the torch binding submits from per-handle threads whose firing order
  differs across ranks.  The negotiation controller already solves this:
  each op is submitted as a named request, and the coordinator's response
  stream (ControllerClient.next_negotiated) is consumed by a single
  dispatcher thread that executes ring ops in response order — exactly
  the reference's design, where the background thread executes the
  coordinator's ResponseList in order (reference controller.h:58-99,
  operations.cc BackgroundThreadLoop).

Ring-routed ops carry a ``ring.`` name prefix so the dispatcher can tell
them apart from XLA-plane negotiations in the same stream.  A rank that
has Joined keeps its dispatcher alive; for a ring op it never submitted
it synthesizes a zero contribution from the response metadata (valid for
sum — the reference's Join supports sum/average only, join.py docs).

The port's arrays carry no bfloat16 (numpy has none without
``ml_dtypes``, which the port does not use; the process plane casts it to
float32 for a reduction), so a bfloat16 wire code is held as uint16.
"""

from __future__ import annotations

import ctypes
import socket
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import metrics as _metrics
from ..utils import env as env_util
from ..utils.logging import get_logger
from . import native
from .controller import DATA_OPS, _dtype_code

log = get_logger(__name__)

RING_PREFIX = "ring."
# The reduce op (and broadcast root) is encoded in the negotiated name
# ("ring.min:<name>", "ring.bcast3:<name>") so a joined rank — which
# never submitted the op — can synthesize the correct identity element
# and root from the response alone.
_OP_TAGS = {"allreduce": "sum", "min": "min", "max": "max"}
_TAG_OPS = {v: k for k, v in _OP_TAGS.items()}

_NP_BY_CODE = {0: "float32", 1: "bfloat16", 2: "float16", 3: "float64",
               4: "int32", 5: "int64"}


def _np_dtype(code: int):
    """The numpy dtype a wire code is held in (bfloat16 as uint16)."""
    name = _NP_BY_CODE.get(code)
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(name or "uint8")


class Ring:
    """The native peer ring (one per process)."""

    def __init__(self, rank: int, nranks: int, *,
                 chunk_bytes: Optional[int] = None):
        self._lib = native.load()
        chunk = chunk_bytes or env_util.get_int("HVD_RING_CHUNK_BYTES",
                                                4 << 20)
        self._h = self._lib.hvd_ring_create(rank, nranks, chunk)
        if not self._h:
            raise RuntimeError("failed to create ring listener")
        self.rank = rank
        self.nranks = nranks

    @property
    def port(self) -> int:
        return self._lib.hvd_ring_port(self._h)

    def connect(self, right_host: str, right_port: int,
                timeout: float = 60.0) -> None:
        host = socket.gethostbyname(right_host)
        rc = self._lib.hvd_ring_connect(
            self._h, host.encode(), right_port, timeout * 1000.0,
        )
        if rc != 0:
            raise ConnectionError(
                f"ring connect to {right_host}:{right_port} failed"
            )

    def allreduce(self, arr: np.ndarray, op: str = "allreduce") -> np.ndarray:
        """In-place ring allreduce; returns the (mutated) array.

        IN-PLACE CONTRACT: a contiguous input is reduced in its own
        buffer (``np.ascontiguousarray`` aliases it); callers that need
        their input preserved must pass a copy.  ``RingExecutor`` copies
        at submit time, so only direct ``Ring`` users carry this burden.
        """
        arr = np.ascontiguousarray(arr)
        rc = self._lib.hvd_ring_allreduce(
            self._h, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes,
            _dtype_code(str(arr.dtype)), DATA_OPS[op],
        )
        if rc != 0:
            raise RuntimeError(f"ring allreduce failed (op={op})")
        return arr

    def broadcast(self, buf: bytearray, root: int) -> bytearray:
        """In-place pipelined ring broadcast of a byte buffer."""
        if len(buf) == 0:
            return buf
        c_buf = (ctypes.c_char * len(buf)).from_buffer(buf)
        rc = self._lib.hvd_ring_broadcast(self._h, c_buf, len(buf), root)
        if rc != 0:
            raise RuntimeError("ring broadcast failed")
        return buf

    def allgather(self, arr: np.ndarray) -> np.ndarray:
        """Equal-block ring allgather: every rank's ``arr`` concatenated
        on dim 0, one rotation per step (csrc/ring.cc Allgather)."""
        arr = np.ascontiguousarray(arr)
        out = np.empty((self.nranks,) + arr.shape, arr.dtype)
        rc = self._lib.hvd_ring_allgather(
            self._h, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes,
            out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
        )
        if rc != 0:
            raise RuntimeError("ring allgather failed")
        return out.reshape((self.nranks * arr.shape[0],) + arr.shape[1:])

    def close(self) -> None:
        if self._h:
            self._lib.hvd_ring_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


class RingExecutor:
    """Serializes ring collectives into the coordinator's response order.

    ``submit`` registers the local payload under a ``ring.``-prefixed
    name and files a negotiation request; the dispatcher thread pops
    negotiated responses and executes the ring transfer for each ring op
    — one at a time, in the same order on every rank.
    """

    def __init__(self, client, ring: Ring):
        self._client = client
        self._ring = ring
        self._lock = threading.Lock()
        self._pending: Dict[str, Tuple[np.ndarray, str, int, Future]] = {}
        self._stopping = False
        client.enable_order_stream()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="hvd-ring-dispatch",
        )
        self._thread.start()

    # -- public API ---------------------------------------------------------
    def allreduce(self, name: str, arr: np.ndarray, *,
                  op: str = "allreduce", timeout: float = 60.0) -> np.ndarray:
        """Ring allreduce of ``arr`` under coordinator ordering (blocking).
        The input is copied at submit time — the native ring reduces in
        place (Ring.allreduce), and the caller's buffer must survive."""
        fut = self._submit(name, np.array(arr, copy=True), op, root=0)
        return fut.result(timeout=timeout)

    def broadcast(self, name: str, arr: np.ndarray, root: int,
                  timeout: float = 60.0) -> np.ndarray:
        fut = self._submit(name, np.ascontiguousarray(arr), "broadcast",
                           root=root)
        return fut.result(timeout=timeout)

    def allgather(self, name: str, arr: np.ndarray,
                  timeout: float = 60.0) -> np.ndarray:
        """Equal-shape ring allgather under coordinator ordering; the
        negotiation runs as type allgather, so Join restrictions apply
        (the coordinator refuses gathers while ranks are joined)."""
        fut = self._submit(name, np.ascontiguousarray(np.atleast_1d(arr)),
                           "allgather", root=0)
        return fut.result(timeout=timeout)

    def close(self) -> None:
        """Stop the dispatcher and free the native ring.  The ring is
        only freed after the dispatcher thread exits — freeing under an
        in-flight transfer would be a use-after-free; if the thread is
        wedged mid-op we deliberately leak the native object instead."""
        self._stopping = True
        self._thread.join(timeout=10)
        _metrics.RING_ACTIVE.set(0)
        if not self._thread.is_alive():
            self._ring.close()
        else:
            _leaked.append(self._ring)  # keep alive; never freed

    # -- internals ----------------------------------------------------------
    def _submit(self, name: str, arr: np.ndarray, op: str,
                root: int) -> Future:
        if op == "broadcast":
            tag = f"bcast{root}"
        elif op == "allgather":
            tag = "gather"
        else:
            tag = _OP_TAGS[op]
        name = f"{RING_PREFIX}{tag}:{name}"
        fut: Future = Future()
        with self._lock:
            if name in self._pending:
                raise ValueError(f"ring op {name!r} already in flight")
            self._pending[name] = (arr, op, root, fut)
        # negotiation request: broadcast/allgather negotiate as their own
        # types (Join restrictions apply), the reduce ops as allreduce
        # (min/max share the type; cross-rank op agreement is enforced by
        # MetaKey's name match + the local subgroup key, and all ranks
        # pass the same op for one name).
        req_op = op if op in ("broadcast", "allgather") else "allreduce"
        try:
            self._client.submit(
                name, op=req_op, shape=arr.shape, dtype=str(arr.dtype),
                root_rank=root,
            )
        except BaseException as e:  # noqa: BLE001 — connection lost etc.
            # unwind the pending entry so a retry under the same name is
            # not rejected as "already in flight" and the Future resolves
            with self._lock:
                self._pending.pop(name, None)
            fut.set_exception(e)
            raise
        return fut

    def _loop(self) -> None:
        while not self._stopping:
            try:
                type_code, err, tensors = self._client.next_negotiated(
                    timeout=1.0,
                )
            except TimeoutError:
                continue
            except ConnectionError:
                self._fail_all(ConnectionError("controller connection lost"))
                return
            ring_names = [t for t in tensors if t[0].startswith(RING_PREFIX)]
            if not ring_names:
                continue  # XLA-plane negotiation; not ours
            if type_code == 6:  # coordinator ERROR response
                self._fail(ring_names, RuntimeError(err))
            else:
                self._execute_group(ring_names, type_code)
            # Drain the per-name Wait entries the client recorded for
            # these responses: ring ops never call wait(), and the
            # entries would otherwise accumulate one per collective.
            for nm, _, _ in ring_names:
                try:
                    self._client.wait(nm, timeout=1.0)
                except Exception:  # noqa: BLE001 — drained either way
                    pass

    @staticmethod
    def _identity(op: str, dtype_code: int, nbytes: int) -> np.ndarray:
        """The identity element for a ring reduce a joined rank must
        contribute: 0 for sum, +inf/dtype-max for min, -inf/dtype-min
        for max (zeros would corrupt min/max).  Float-ness comes from the
        wire dtype code, not np.dtype.kind."""
        dt = _np_dtype(dtype_code)
        n = max(nbytes, 0) // dt.itemsize
        is_float = dtype_code in (0, 1, 2, 3)
        if op == "min":
            fill = np.inf if is_float else np.iinfo(dt).max
        elif op == "max":
            fill = -np.inf if is_float else np.iinfo(dt).min
        else:
            fill = 0
        return np.full(n, fill, dt)

    def _execute_group(self, ring_names, type_code: int) -> None:
        """Execute one negotiated group of ring ops.

        The coordinator already fused small same-type tensors into one
        response (csrc/controller.cc FuseResponses); this is the host
        plane's fusion *buffer*: same-(op, dtype) reduce ops in the group
        concatenate into a single ring transfer — one 2(n−1)-hop
        schedule instead of one per tensor (the reference's fusion
        buffer, common/operations.cc FuseResponses + buffer assembly).
        Bucket order follows group order, so every rank runs identical
        transfers.  Broadcasts execute singly (different roots can't
        share a buffer)."""
        buckets = {}
        singles = []
        for nm, dtype_code, nbytes in ring_names:
            tag = nm[len(RING_PREFIX):].partition(":")[0]
            if tag in _TAG_OPS:
                buckets.setdefault((tag, dtype_code), []).append(
                    (nm, dtype_code, nbytes))
            else:
                singles.append((nm, dtype_code, nbytes))
        for nm, dtype_code, nbytes in singles:
            self._execute(nm, dtype_code, nbytes, type_code)
        for (tag, dtype_code), items in buckets.items():
            if len(items) == 1:
                nm, dc, nb = items[0]
                self._execute(nm, dc, nb, type_code)
            else:
                self._execute_fused(tag, dtype_code, items)

    def _execute_fused(self, tag: str, dtype_code: int, items) -> None:
        op = _TAG_OPS[tag]
        parts, futs = [], []
        for nm, _, nbytes in items:
            with self._lock:
                entry = self._pending.pop(nm, None)
            if entry is None:  # joined rank: identity contribution
                parts.append((self._identity(op, dtype_code, nbytes),
                              None, nbytes))
                futs.append(None)
            else:
                arr, _, _, fut = entry
                parts.append((arr, arr.shape, nbytes))
                futs.append(fut)
        try:
            for (arr, _, nbytes), (nm, _, _) in zip(parts, items):
                if arr.nbytes != nbytes:
                    raise ValueError(
                        f"ring op {nm!r}: local payload is {arr.nbytes} B "
                        f"but the negotiated size is {nbytes} B"
                    )
            flat = np.concatenate([a.ravel() for a, _, _ in parts])
            out = self._ring.allreduce(flat, op=op)
            if _metrics.on():
                _metrics.RING_OPS.labels(op).inc()
                _metrics.RING_BYTES.inc(flat.nbytes)
            off = 0
            for (arr, shape, _), fut in zip(parts, futs):
                n = arr.size
                if fut is not None:
                    fut.set_result(out[off: off + n].reshape(shape))
                off += n
        except BaseException as e:  # noqa: BLE001
            delivered = False
            for fut in futs:
                if fut is not None and not fut.done():
                    fut.set_exception(e)
                    delivered = True
            if not delivered:  # all-joined group: nobody to tell — log
                log.warning("joined-rank fused ring group failed: %s", e)

    def _execute(self, name: str, dtype_code: int, nbytes: int,
                 type_code: int) -> None:
        with self._lock:
            entry = self._pending.pop(name, None)
        fut = None
        try:
            tag = name[len(RING_PREFIX):].partition(":")[0]
            if entry is None:
                # Joined rank: participate with the op's identity element
                # so the ring stays connected (reference Join semantics,
                # controller.cc:253-264: joined ranks are implicit
                # members).  gather/bcast cannot reach here under Join —
                # the coordinator errors them — but keep the ring alive
                # defensively with a zero block.
                if tag.startswith("bcast"):
                    arr = np.zeros(max(nbytes, 0), np.uint8)
                    op, root = "broadcast", int(tag[len("bcast"):])
                elif tag == "gather":
                    arr = np.zeros(max(nbytes, 0), np.uint8)
                    op, root = "allgather", 0
                else:
                    op = _TAG_OPS.get(tag, "allreduce")
                    arr = self._identity(op, dtype_code, nbytes)
                    root = 0
            else:
                arr, op, root, fut = entry
            if arr.nbytes != nbytes:
                # canonical size from the first submitter disagrees with
                # ours — executing would desync the byte stream for every
                # later ring op; fail this op loudly instead
                raise ValueError(
                    f"ring op {name!r}: local payload is {arr.nbytes} B "
                    f"but the negotiated size is {nbytes} B — all ranks "
                    "must pass identically-shaped tensors"
                )
            if op == "broadcast":
                buf = bytearray(arr.tobytes())
                # writes into buf in place
                self._ring.broadcast(buf, root)
                out = np.frombuffer(buf, arr.dtype).reshape(arr.shape)
            elif op == "allgather":
                out = self._ring.allgather(arr)
            else:
                out = self._ring.allreduce(arr, op=op)
            if _metrics.on():
                _metrics.RING_OPS.labels(op).inc()
                _metrics.RING_BYTES.inc(arr.nbytes)
            if fut is not None:
                fut.set_result(out)
        except BaseException as e:  # noqa: BLE001
            if fut is not None:
                fut.set_exception(e)
            else:
                log.warning("joined-rank ring op %s failed: %s", name, e)

    def _fail(self, tensors, exc) -> None:
        for nm, _, _ in tensors:
            with self._lock:
                entry = self._pending.pop(nm, None)
            if entry is not None:
                entry[3].set_exception(exc)

    def _fail_all(self, exc) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
        for arr, op, root, fut in pending.values():
            fut.set_exception(exc)


def _iface_ip(names: str) -> Optional[str]:
    """IPv4 address of the first resolvable interface in the comma list
    (reference --network-interface semantics: the operator names the
    NIC(s) the data plane must ride; each worker resolves locally)."""
    import fcntl
    import struct

    for name in names.split(","):
        name = name.strip()
        if not name:
            continue
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            packed = struct.pack("256s", name.encode()[:255])
            addr = fcntl.ioctl(s.fileno(), 0x8915, packed)[20:24]
            return socket.inet_ntoa(addr)  # 0x8915 = SIOCGIFADDR
        except OSError:
            continue
        finally:
            s.close()
    log.warning("no interface in %r has an IPv4 address", names)
    return None


def establish(client, rank: int, nranks: int, *,
              host: Optional[str] = None) -> Optional[RingExecutor]:
    """Bring up the ring: listener → address allgather over the star →
    dial the right neighbor → all-ranks-ok agreement → executor.

    Every rank participates in both allgathers even after a local
    failure, and the ring only activates when EVERY rank connected —
    a half-established ring (some ranks falling back to the star) would
    deadlock the first large collective.  Returns None (on all ranks,
    consistently) when any link failed."""
    # Advertised-address priority: explicit arg > operator's NIC
    # override (--network-interface, resolved per worker) > the
    # launcher-known hostname (HVD_RING_HOST) > self-resolution.
    # A mandated-but-unresolvable NIC list raises: silently advertising
    # another interface (typically the management NIC) would ride the
    # wrong network — fail at launch, as the reference does for an
    # absent GLOO_IFACE.  But the raise happens AFTER both setup
    # allgathers: a rank that bails before them (heterogeneous NIC
    # names resolving on some workers only) would leave resolving peers
    # blocked in establish() until the stall deadline instead of
    # degrading fast.
    nic_error: Optional[str] = None
    my_host = host
    if not my_host:
        ifaces = env_util.get_str(env_util.HVD_NETWORK_INTERFACE)
        if ifaces:
            my_host = _iface_ip(ifaces)
            if my_host is None:
                nic_error = (
                    f"none of the interfaces in "
                    f"--network-interface={ifaces!r} has an IPv4 "
                    "address on this worker"
                )
                if client is None:  # no peers to unblock
                    raise RuntimeError(nic_error)
    ring = None
    addr = b""
    if nic_error is None:
        try:
            ring = Ring(rank, nranks)
            my_host = my_host or env_util.get_str("HVD_RING_HOST") \
                or socket.gethostbyname(socket.gethostname())
            addr = f"{my_host}:{ring.port}".encode()
        except Exception as e:  # noqa: BLE001
            log.warning("ring listener failed: %s", e)

    addrs: List[bytes] = client.allgather_data("ring.__setup__", addr)
    ok = ring is not None and all(addrs)
    if ok:
        try:
            right = addrs[(rank + 1) % nranks].decode()
            right_host, right_port = right.rsplit(":", 1)
            ring.connect(right_host, int(right_port))
        except Exception as e:  # noqa: BLE001
            log.warning("ring connect failed: %s", e)
            ok = False

    oks = client.allgather_data("ring.__ok__", b"1" if ok else b"0")
    if nic_error is not None:
        # both allgathers done — peers have already degraded to the
        # star consistently; now surface the launch error locally
        raise RuntimeError(nic_error)
    if not all(o == b"1" for o in oks):
        if ring is not None:
            ring.close()
        log.warning("ring plane disabled: ranks not all connected; "
                    "host collectives stay on the coordinator star")
        _metrics.RING_ACTIVE.set(0)
        return None
    _metrics.RING_ACTIVE.set(1)
    return RingExecutor(client, ring)


_leaked: List[Ring] = []
