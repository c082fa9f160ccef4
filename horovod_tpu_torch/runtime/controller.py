"""Python interface to the native negotiation controller: the port of
``horovod_tpu/runtime/controller.py``.

The eager-plane control protocol (see ``csrc/controller.cc`` for the
design and the reference citations): worker processes submit named
tensors; the coordinator validates cross-rank agreement, fuses, and
broadcasts response lists, so all processes issue identical collectives
in identical order — Horovod's original raison d'être (reference
controller.h:58-99 protocol doc).  The coordinator also carries the host
data plane (``allreduce_data`` / ``allgather_data`` /
``broadcast_data``: the Gloo-CPU-ops analog, ``HandleData``).

The server and client are the C++ of ``csrc/`` through ctypes
(``runtime/native.py``), the same sources the JAX package builds, so a
port client and a reference server (or the other way round) speak one
wire protocol.  Arrays cross as numpy.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import env as env_util
from . import native

# RequestType / DataType codes must match csrc/common.h.
REQUEST_TYPES = {
    "allreduce": 0, "allgather": 1, "broadcast": 2, "join": 3,
    "adasum": 4, "alltoall": 5,
}
# Host data-plane op codes (the kData op byte, csrc/controller.cc
# HandleData/ComputeDataResult): negotiation types plus elementwise
# min/max, which have no negotiation RequestType of their own.
DATA_OPS = dict(REQUEST_TYPES, min=6, max=7)
_DTYPES = {
    "float32": 0, "bfloat16": 1, "float16": 2, "float64": 3,
    "int32": 4, "int64": 5, "uint8": 6, "bool": 7,
}


def _dtype_code(dtype) -> int:
    """The wire code of a numpy dtype, a torch dtype or a dtype name
    (float32 for a name the wire does not know, as the reference)."""
    name = str(dtype).replace("torch.", "")
    if name != "bfloat16":
        try:
            name = str(np.dtype(name if isinstance(dtype, str) else dtype))
        except TypeError:
            pass
    return _DTYPES.get(name, 0)


def _peer_status_suffix() -> str:
    """Name the missing ranks on a negotiation timeout: the rendezvous
    ``GET /health`` lease verdicts say which ranks are still renewing and
    which went silent, so operators — and the elastic driver — can
    identify the dead rank from the error itself instead of replaying the
    job.  Best-effort: an un-wired or unreachable rendezvous yields an
    empty suffix, never a second failure."""
    try:
        from ..elastic.abort import _rendezvous_from_env

        wired = _rendezvous_from_env()
        if wired is None:
            return ""
        from ..run.http_client import get_health

        addr, port, secret = wired
        report = get_health(addr, port, secret=secret, timeout=2.0)
        ranks = report.get("ranks", {})
        if not ranks:
            return ""
        by_verdict: dict = {}
        for rank in sorted(ranks, key=lambda r: (len(r), r)):
            verdict = ranks[rank].get("verdict", "unknown")
            by_verdict.setdefault(verdict, []).append(rank)
        detail = ", ".join(
            f"{v}=[{','.join(by_verdict[v])}]"
            for v in ("live", "stale", "dead", "unknown") if v in by_verdict
        )
        missing = by_verdict.get("dead", []) + by_verdict.get("stale", [])
        hint = (f"; rank(s) {','.join(missing)} have not arrived"
                if missing else "")
        return f" (rank health: {detail}{hint})"
    except Exception:  # noqa: BLE001 — diagnosis must not mask the timeout
        return ""


class ControllerServer:
    """Coordinator (rank 0 owns it; reference: the coordinator role in
    controller.cc:196-326)."""

    def __init__(self, nranks: int, *, port: int = 0,
                 cycle_ms: Optional[float] = None,
                 fusion_threshold: Optional[int] = None,
                 stall_warn_sec: Optional[float] = None):
        lib = native.load()
        self._lib = lib
        self._h = lib.hvd_server_start(
            port, nranks,
            cycle_ms if cycle_ms is not None else env_util.cycle_time_ms(),
            fusion_threshold if fusion_threshold is not None
            else env_util.fusion_threshold_bytes(),
            stall_warn_sec if stall_warn_sec is not None
            else env_util.get_float(env_util.HVD_STALL_CHECK_TIME_SECONDS,
                                    env_util.DEFAULT_STALL_WARNING_SECONDS),
        )
        if not self._h:
            raise RuntimeError("failed to start controller server")
        # Coordinator counters ride the metrics plane as polled gauges —
        # the scrape-time analog of the reference's rank-0-only stats
        # (controller.cc:164-193), now visible wherever the server lives.
        # _handle_lock orders collect() against stop(): a scrape-thread
        # collector passing an unguarded handle check while stop() frees
        # the native object would call into freed memory.  The collector
        # holds only a WEAK reference (a strong closure would pin the
        # server forever in the global registry and disable the __del__
        # safety net), and its key is per-instance so two servers in one
        # process never clobber each other's registration.
        import threading
        import weakref

        self._handle_lock = threading.Lock()
        self._collector_key = f"controller_server:{id(self)}"
        from ..metrics import (
            CONTROLLER_CACHE_HITS, CONTROLLER_CYCLES, CONTROLLER_STALLS,
            registry,
        )

        ref = weakref.ref(self)

        def collect() -> None:
            srv = ref()
            if srv is None:
                return
            with srv._handle_lock:
                if not srv._h:
                    return
                CONTROLLER_CYCLES.set(srv.cycles)
                CONTROLLER_CACHE_HITS.set(srv.cache_hits)
                CONTROLLER_STALLS.set(srv.stall_warnings)

        registry.register_collector(self._collector_key, collect)

    @property
    def port(self) -> int:
        return self._lib.hvd_server_port(self._h)

    @property
    def cache_hits(self) -> int:
        return self._lib.hvd_server_cache_hits(self._h)

    @property
    def cycles(self) -> int:
        return self._lib.hvd_server_cycles(self._h)

    @property
    def stall_warnings(self) -> int:
        return self._lib.hvd_server_stall_warnings(self._h)

    def stop(self) -> None:
        if self._h:
            from ..metrics import registry

            registry.unregister_collector(self._collector_key)
            with self._handle_lock:
                self._lib.hvd_server_stop(self._h)
                self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:  # noqa: BLE001
            pass


class ControllerClient:
    """Per-process worker client (reference: the worker role,
    SendReadyTensors/RecvFinalTensors in mpi_controller.cc:107-120)."""

    def __init__(self, host: str, port: int, rank: int):
        lib = native.load()
        self._lib = lib
        self._h = lib.hvd_client_connect(host.encode(), port, rank)
        if not self._h:
            raise RuntimeError(f"failed to connect controller {host}:{port}")
        self.rank = rank

    def submit(self, name: str, *, op: str = "allreduce",
               shape: Sequence[int] = (), dtype="float32",
               root_rank: int = 0) -> None:
        arr = (ctypes.c_longlong * len(shape))(*shape)
        rc = self._lib.hvd_client_submit(
            self._h, name.encode(), REQUEST_TYPES[op], _dtype_code(dtype),
            self.rank, root_rank, arr, len(shape),
        )
        if rc != 0:
            raise RuntimeError("controller submit failed (connection lost)")

    def wait(self, name: str, timeout: float = 60.0) -> List[str]:
        """Block until `name` is negotiated; returns the fused group (the
        tensors to execute in one collective).  Raises on error responses
        (the reference surfaces coordinator ERROR responses as Python
        exceptions, ops/collective_operations.cc:230-232)."""
        err = ctypes.create_string_buffer(4096)
        group = ctypes.create_string_buffer(1 << 16)
        rc = self._lib.hvd_client_wait(
            self._h, name.encode(), timeout * 1000.0,
            err, len(err), group, len(group),
        )
        if rc == 0:
            g = group.value.decode()
            return g.split(";") if g else [name]
        if rc == 1:
            raise RuntimeError(err.value.decode())
        if rc == 2:
            raise TimeoutError(
                f"negotiation of {name!r} timed out{_peer_status_suffix()}")
        raise ConnectionError("controller connection lost")

    def submit_data(self, name: str, payload: bytes, *,
                    op: str = "allreduce", dtype="uint8",
                    root_rank: int = 0) -> None:
        """Send this rank's payload for the host data plane (the Gloo-CPU-ops
        analog living in the coordinator, csrc/controller.cc HandleData)."""
        rc = self._lib.hvd_client_submit_data(
            self._h, name.encode(), DATA_OPS[op], _dtype_code(dtype),
            root_rank, payload, len(payload),
        )
        if rc != 0:
            raise RuntimeError("controller submit_data failed (connection lost)")

    def wait_data(self, name: str, timeout: float = 60.0) -> bytes:
        """Block for the coordinator's reduced/gathered payload."""
        n = ctypes.c_longlong(0)
        err = ctypes.create_string_buffer(1024)
        rc = self._lib.hvd_client_wait_data(
            self._h, name.encode(), timeout * 1000.0, None, 0,
            ctypes.byref(n), err, len(err),
        )
        if rc == 4:  # result ready; fetch with a right-sized buffer
            buf = ctypes.create_string_buffer(max(int(n.value), 1))
            rc = self._lib.hvd_client_wait_data(
                self._h, name.encode(), timeout * 1000.0, buf, n.value,
                ctypes.byref(n), err, len(err),
            )
            if rc == 0:
                return buf.raw[: int(n.value)]
        if rc == 0:  # zero-length result
            return b""
        if rc == 1:
            raise RuntimeError(err.value.decode())
        if rc == 2:
            raise TimeoutError(
                f"host collective {name!r} timed out{_peer_status_suffix()}")
        raise ConnectionError("controller connection lost")

    def allreduce_data(self, name: str, arr: "np.ndarray",
                       timeout: float = 60.0,
                       op: str = "allreduce") -> "np.ndarray":
        """Reduce ``arr`` elementwise across all ranks on the coordinator.
        ``op``: allreduce (sum), min, max, or adasum (real VHDD tree,
        csrc/controller.cc AdasumReduce).  Caller divides for Average
        (the reference's divisor trick, torch/mpi_ops.py:94-129)."""
        arr = np.ascontiguousarray(arr)
        dtype = str(arr.dtype)
        if dtype not in ("float32", "float64", "int32", "int64",
                         "bfloat16", "float16"):
            raise TypeError(f"host allreduce unsupported for dtype {dtype}")
        self.submit_data(name, arr.tobytes(), op=op, dtype=dtype)
        out = self.wait_data(name, timeout=timeout)
        return np.frombuffer(out, arr.dtype).reshape(arr.shape).copy()

    def allgather_data(self, name: str, payload: bytes,
                       timeout: float = 60.0) -> List[bytes]:
        """Gather each rank's variable-length payload; returns the list in
        rank order (wire format: u32 count, u32 sizes, blobs)."""
        self.submit_data(name, payload, op="allgather")
        out = self.wait_data(name, timeout=timeout)
        import struct

        (count,) = struct.unpack_from("<I", out, 0)
        sizes = struct.unpack_from(f"<{count}I", out, 4)
        blobs, off = [], 4 + 4 * count
        for s in sizes:
            blobs.append(out[off: off + s])
            off += s
        return blobs

    def broadcast_data(self, name: str, payload: bytes, root_rank: int = 0,
                       timeout: float = 60.0) -> bytes:
        self.submit_data(name, payload, op="broadcast", root_rank=root_rank)
        return self.wait_data(name, timeout=timeout)

    def enable_order_stream(self) -> None:
        """Start recording negotiated responses in coordinator order (the
        execution order the ring executor follows — reference
        controller.h:58-99: the response list IS the execution order)."""
        self._lib.hvd_client_enable_order_stream(self._h)

    def next_negotiated(self, timeout: float = 60.0):
        """Pop the next negotiated response: ``(type_code, error_message,
        [(name, dtype_code, nbytes), ...])`` in coordinator-broadcast
        order — identical on every rank.  Raises TimeoutError /
        ConnectionError."""
        n = ctypes.c_longlong(0)
        buf = ctypes.create_string_buffer(1 << 16)
        rc = self._lib.hvd_client_next_negotiated(
            self._h, timeout * 1000.0, buf, len(buf), ctypes.byref(n),
        )
        if rc == 4:  # huge fused group: retry with the exact size
            buf = ctypes.create_string_buffer(int(n.value))
            rc = self._lib.hvd_client_next_negotiated(
                self._h, timeout * 1000.0, buf, len(buf), ctypes.byref(n),
            )
        if rc == 2:
            raise TimeoutError("no negotiated response within timeout")
        if rc != 0:
            raise ConnectionError("controller connection lost")
        raw = buf.raw[: int(n.value)].decode()
        records = raw.split("\x1e")
        type_s, _, err = records[0].partition("\x1f")
        tensors = []
        for rec in records[1:]:
            name, dtype_s, bytes_s = rec.split("\x1f")
            tensors.append((name, int(dtype_s), int(bytes_s)))
        return int(type_s), err, tensors

    def stats(self, timeout: float = 10.0) -> dict:
        """Query the coordinator's counters over the wire — lets any rank
        observe negotiation health when the server lives in the launcher
        (the reference surfaces these rank-0-side only,
        controller.cc:164-193)."""
        cycles = ctypes.c_longlong(0)
        hits = ctypes.c_longlong(0)
        stalls = ctypes.c_longlong(0)
        rc = self._lib.hvd_client_stats(
            self._h, timeout * 1000.0,
            ctypes.byref(cycles), ctypes.byref(hits), ctypes.byref(stalls),
        )
        if rc == 2:
            raise TimeoutError("controller stats query timed out")
        if rc != 0:
            raise ConnectionError("controller connection lost")
        return {
            "cycles": int(cycles.value),
            "cache_hits": int(hits.value),
            "stall_warnings": int(stalls.value),
        }

    def join(self) -> None:
        self._lib.hvd_client_join(self._h)

    def wait_join(self, timeout: float = 60.0) -> None:
        rc = self._lib.hvd_client_wait_join(self._h, timeout * 1000.0)
        if rc == 2:
            raise TimeoutError(f"join timed out{_peer_status_suffix()}")
        if rc == 3:
            raise ConnectionError("controller connection lost")

    def close(self) -> None:
        if self._h:
            self._lib.hvd_client_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
