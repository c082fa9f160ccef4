"""Process-wide eager-plane controller wiring: the port of
``horovod_tpu/runtime/eager_controller.py``.

Connects the process plane (``eager.py``: ``broadcast_object``,
``allgather_object``, ``process_*``) to the native negotiation controller
(``runtime/controller.py``) and the peer ring (``runtime/ring.py``):
under ``HVD_CONTROLLER=native`` those calls negotiate with the
coordinator and ride its host data plane, large payloads on the ring, so
every process issues identical host collectives in identical order (the
deadlock / mismatch protection that is Horovod's original purpose;
reference controller.h:58-99).  Single-process jobs skip it entirely.
The device collectives (``ops/collectives.py``, the train step) stay on
``torch.distributed``.

The launcher (``python -m horovod_tpu_torch.run``) selects this with
``HVD_CONTROLLER=native`` and points workers at the coordinator with
``HVD_CONTROLLER_ADDR=host:port``; it hosts the server itself
(``HVD_CONTROLLER_SERVER=external``), and otherwise process 0 does.
"""

from __future__ import annotations

import atexit
import os
from typing import List, Optional, Sequence

from ..utils import env as env_util
from ..utils.logging import get_logger

log = get_logger(__name__)

_server = None
_client = None
_ring_exec = None


def setup_from_env(process_id: int, num_processes: int) -> None:
    """Called from hvd.init().  No-op unless HVD_CONTROLLER=native and the
    job spans multiple controller processes."""
    global _server, _client, _ring_exec
    if _client is not None or num_processes <= 1:
        return
    if env_util.get_str(env_util.HVD_CONTROLLER) != "native":
        return
    addr = env_util.get_str(env_util.HVD_CONTROLLER_ADDR)
    if not addr:
        log.warning("HVD_CONTROLLER=native but HVD_CONTROLLER_ADDR unset")
        return
    host, port_s = addr.rsplit(":", 1)
    port = int(port_s)
    import socket

    # the native client dials an IP (inet_pton); resolve hostnames here
    host = socket.gethostbyname(host)
    from .controller import ControllerClient, ControllerServer

    # The launcher (run/run.py, the elastic driver) hosts the server itself
    # and marks it external — it binds port 0 there, so no remote-host port
    # race.  Only self-assembled jobs start the server in process 0.
    if process_id == 0 and \
            env_util.get_str(env_util.HVD_CONTROLLER_SERVER) != "external":
        _server = ControllerServer(num_processes, port=port)
    _client = ControllerClient(host, port, process_id)
    atexit.register(shutdown)
    # Peer ring for large host payloads (HVD_RING=0 keeps everything on
    # the coordinator star — debugging aid).
    if env_util.get_int(env_util.HVD_RING, 1):
        from . import ring as ring_mod

        # establish() degrades collectively: it returns None on EVERY
        # rank when any link failed, so no rank is left ringing alone
        _ring_exec = ring_mod.establish(_client, process_id, num_processes)
    log.info("eager controller active: %s (process %d/%d, ring=%s)",
             addr, process_id, num_processes, _ring_exec is not None)


def active() -> bool:
    return _client is not None


def client():
    """The process's ControllerClient (None when negotiation is inactive).
    Exposes the host data plane: allreduce_data/allgather_data/
    broadcast_data (csrc/controller.cc HandleData — the Gloo-CPU-ops
    analog, reference horovod/common/ops/gloo_operations.cc)."""
    return _client


def ring():
    """The process's RingExecutor (None when the peer ring is down) — the
    scalable path for large host payloads (csrc/ring.cc)."""
    return _ring_exec


_seq = 0


def next_name(prefix: str) -> str:
    """Sequential default tensor names, identical across processes when ops
    are issued in the same order (the reference's handle-derived default
    names, torch/mpi_ops.py allreduce.noname.N); every plane's default
    names (``eager.py``, the torch frontend) draw from this one counter."""
    global _seq
    _seq += 1
    return f"{prefix}.{_seq}"


def negotiate(name: str, *, op: str, shape: Sequence[int], dtype,
              root_rank: int = 0, timeout: float = 60.0) -> Optional[List[str]]:
    """Submit + wait; returns the fused group, or None when negotiation is
    inactive (single controller).  The fault harness's controller seam
    fires first (``HVD_FAULT_SPEC``, ``elastic/faults.py``)."""
    if _client is None:
        return None
    from ..elastic import faults

    faults.on_controller(name)  # HVD_FAULT_SPEC: partition/hang/slow here
    _client.submit(name, op=op, shape=tuple(int(d) for d in shape),
                   dtype=str(dtype), root_rank=root_rank)
    return _client.wait(name, timeout=timeout)


def join(timeout: float = 60.0) -> None:
    if _client is None:
        return
    _client.join()
    _client.wait_join(timeout=timeout)


def server_stats() -> Optional[dict]:
    """Coordinator counters: read locally when this process hosts the
    server, otherwise queried over the wire (launcher-hosted server)."""
    if _server is not None:
        return {
            "cache_hits": _server.cache_hits,
            "cycles": _server.cycles,
            "stall_warnings": _server.stall_warnings,
        }
    if _client is not None:
        try:
            return _client.stats()
        except (TimeoutError, ConnectionError, OSError):
            # no-raise contract: a wedged or shut-down coordinator reads
            # as "no stats available", same as not having one
            return None
    return None


def shutdown() -> None:
    global _server, _client, _ring_exec
    if _ring_exec is not None:
        _ring_exec.close()  # joins the dispatcher, then frees the ring
        _ring_exec = None
    if _client is not None:
        _client.close()
        _client = None
    if _server is not None:
        _server.stop()
        _server = None
