"""Initialization and the rank model, on one ``torch.distributed`` group.

The port of ``horovod_tpu/core.py`` and ``spmd.py``.  The reference runs
one SPMD program over a device mesh, with a rank per device; here every
rank is a process that drives one card, and "the code every rank runs"
takes the place of the SPMD region.  The collectives run on one process
group: NCCL for CUDA tensors, gloo for CPU tensors.

Process identity comes from the same environment the reference's
``core.init`` reads (``HVD_COORDINATOR_ADDR``, ``HVD_NUM_PROCESSES``,
``HVD_PROCESS_ID``); with none of it set, the world is one process on an
in-process store.  ``HVD_LOCAL_SIZE`` gives the processes per host (the
whole world by default), from which the local and cross ranks follow as
in the reference's ``(cross, local)`` mesh.

The rendezvous at ``HVD_COORDINATOR_ADDR`` is bounded: every rank waits
at most ``HVD_START_TIMEOUT`` seconds (60 by default) for the others to
join, then raises, so a rank that never arrives fails the job with its
error instead of hanging it.

The launcher (``python -m horovod_tpu_torch.run``) serves the store
itself and says so with ``HVD_COORDINATOR_SERVER=external``: then every
rank joins it as a client (``run/run.py``).

``init`` opens the per-rank timeline when ``HVD_TIMELINE`` /
``HVD_TRACE_DIR`` is set, as the reference's does, and ``shutdown``
closes it (writing ``metrics.json`` beside ``comm.json``).  After the
group is joined it starts the control plane the launcher wired
(``HVD_METRICS_KV_*``): the relay, the metrics pusher and time-series
flusher keyed by this rank, and the heartbeat leases.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

from .utils import env as env_util
from .utils.logging import get_logger

log = get_logger(__name__)

#: the job's mesh axis names, as horovod_tpu.core names them: the world's
#: 1-D axis, and the hierarchical (cross, local) axes
AXIS = "hvd"
CROSS_AXIS = "cross"
LOCAL_AXIS = "local"

# Reduction op constants, as horovod_tpu.core names them.
Average = "Average"
Sum = "Sum"
Adasum = "Adasum"
Min = "Min"
Max = "Max"


class NotInitializedError(RuntimeError):
    def __init__(self) -> None:
        super().__init__(
            "horovod_tpu_torch has not been initialized; call init() first.")


@dataclasses.dataclass(frozen=True)
class _World:
    device: torch.device
    backend: str
    rank: int
    size: int
    local_size: int


# The process group is process-global in torch.distributed, so the world
# that describes it is too.
_world: Optional[_World] = None
#: the arguments of the last init(), which reinit() replays
_init_kwargs: dict = {}
#: how many worlds this process has joined; what was built for one world
#: (a process set's group, a captured train step) checks it
_epoch = 0


def init(device=None, backend: Optional[str] = None) -> None:
    """Join the job's process group and pick this rank's device.

    ``device=None`` means the card ``cuda:<local_rank>`` and raises when
    there is none; the CPU is used only when asked for (``device="cpu"``).
    ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the CPU; a
    device-keyed string such as ``"cpu:gloo,cuda:nccl"`` serves tensors on
    both.  Idempotent, like ``hvd.init()``.
    """
    global _world, _init_kwargs, _epoch
    if _world is not None:
        return
    size = env_util.get_int(env_util.HVD_NUM_PROCESSES, 1)
    rank = env_util.get_int(env_util.HVD_PROCESS_ID, 0)
    local_size = env_util.get_int(env_util.HVD_LOCAL_SIZE, size)
    if size < 1 or not 0 <= rank < size:
        raise ValueError(f"bad process identity: rank {rank} of {size}")
    if local_size < 1 or size % local_size:
        raise ValueError(
            f"world size {size} not divisible by local size {local_size}")
    local_rank = rank % local_size

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")

    addr = env_util.get_str(env_util.HVD_COORDINATOR_ADDR)
    if addr:
        dist.init_process_group(backend, store=_rendezvous(addr, rank, size),
                                rank=rank, world_size=size)
    elif size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise RuntimeError(
            f"{env_util.HVD_NUM_PROCESSES}={size} needs "
            f"{env_util.HVD_COORDINATOR_ADDR} (host:port of rank 0)")
    _world = _World(device=dev, backend=backend, rank=rank, size=size,
                    local_size=local_size)
    _init_kwargs = {"device": device, "backend": backend}
    _epoch += 1
    log.info("initialized: rank=%d size=%d local_size=%d device=%s "
             "backend=%s", rank, size, local_size, dev, backend)
    # env-driven timeline start-up, as the reference's core does when
    # HVD_TIMELINE / HVD_TRACE_DIR is set (a no-op otherwise)
    from .timeline.timeline import timeline

    timeline.initialize()
    _start_control_plane(rank)


def _start_control_plane(rank: int) -> None:
    """The launcher-wired control plane, started after the group is
    joined, in the reference's order (``horovod_tpu/core.py:276-314``):
    the per-host relay (``HVD_RELAY=1``, local rank 0), the metrics
    pusher and the time-series flusher keyed by this process's ``rank``
    (``HVD_METRICS_KV_*``), and heartbeat leases with the abort poll (a
    world of more than one process).  Each is a no-op without its
    wiring; a setup failure is logged and never fails ``init``.  The
    stall inspector's thread starts too (``HVD_STALL_CHECK_DISABLE=1``
    keeps it off)."""
    from .elastic import heartbeat
    from .metrics import push, timeseries
    from .run import relay
    from .runtime.stall_inspector import inspector

    inspector.start()
    # the relay is elected by HVD_LOCAL_RANK and the lease keyed by
    # HVD_PROCESS_ID, as in the reference
    for what, start in (
            ("relay", relay.start_from_env),
            ("metrics pusher", lambda: push.start_pusher_from_env(rank)),
            ("timeseries flusher",
             lambda: timeseries.start_flusher_from_env(rank)),
            ("heartbeat", heartbeat.start_from_env)):
        try:
            start()
        except NotImplementedError:
            shutdown()  # an unported plane the environment asks for:
            raise       # leave no group behind
        except Exception as e:  # noqa: BLE001 — the control plane must
            log.warning("%s setup failed: %s", what, e)  # never block init


def _rendezvous(addr: str, rank: int, size: int) -> dist.TCPStore:
    """The job's store at ``host:port``, each rank waiting at most
    ``HVD_START_TIMEOUT`` seconds for the others; past that it raises.

    With ``HVD_COORDINATOR_SERVER=external`` the launcher serves the
    store (``run/run.py``, on a port it bound itself) and every rank
    joins as a client, then counts itself in under a key of this world
    (:func:`epoch`) and waits until all ``size`` have.  Otherwise rank 0
    serves it (or joins a server this process already runs there) and
    waits in the constructor until all ``size`` ranks have reached it."""
    host, _, port = addr.rpartition(":")
    timeout = datetime.timedelta(seconds=env_util.get_float(
        env_util.HVD_START_TIMEOUT, env_util.DEFAULT_START_TIMEOUT_SECONDS))
    if env_util.get_str(env_util.HVD_COORDINATOR_SERVER) != "external":
        return dist.TCPStore(host, int(port), size, is_master=rank == 0,
                             timeout=timeout, wait_for_workers=True,
                             multi_tenant=True)
    store = dist.TCPStore(host, int(port), size, is_master=False,
                          timeout=timeout)
    joined, ready = (f"hvd/init/{_epoch + 1}/{k}" for k in ("joined",
                                                            "ready"))
    if store.add(joined, 1) == size:
        store.set(ready, "1")
    store.wait([ready], timeout)
    return store


def shutdown() -> None:
    """Leave the process group (``hvd.shutdown()``)."""
    global _world
    if _world is None:
        return
    from .timeline.timeline import timeline

    timeline.shutdown()
    _stop_control_plane()
    if dist.is_initialized():
        dist.destroy_process_group()
    _world = None


def _stop_control_plane() -> None:
    """Stop what :func:`_start_control_plane` started, each flushing
    once more (the reference's ``shutdown``)."""
    from .elastic import heartbeat
    from .metrics.push import stop_pusher
    from .metrics.timeseries import stop_flusher
    from .run import relay
    from .runtime.stall_inspector import inspector

    for stop in (stop_pusher, stop_flusher, heartbeat.stop, relay.stop,
                 inspector.stop):
        try:
            stop()
        except Exception as e:  # noqa: BLE001
            log.debug("control-plane stop failed: %s", e)


def reinit() -> None:
    """Leave the process group and join it again against the current
    environment, with the device selection of the last :func:`init`
    (reference ``core.reinit``).  What was built for the old world (a
    :class:`~horovod_tpu_torch.ops.collectives.ProcessSet`, a train step)
    raises on its next use.  A process that never initialized gets a
    plain :func:`init`."""
    kwargs = dict(_init_kwargs)
    shutdown()
    init(**kwargs)


def epoch() -> int:
    """The number of worlds this process has joined (0 before the first
    :func:`init`); what was built for one world compares it."""
    return _epoch


#: the meshes made for the current world, by kind
_meshes: dict = {}


def _mesh(kind: str, shape, names):
    _require_init()
    key = (kind, _epoch)
    if key not in _meshes:
        from .parallel.mesh import make_mesh

        for old in [k for k in _meshes if k[1] != _epoch]:
            del _meshes[old]  # a mesh of an earlier world holds its groups
        _meshes[key] = make_mesh(shape, names)
    return _meshes[key]


def mesh():
    """The world as a 1-D ``DeviceMesh`` with axis :data:`AXIS` (the
    reference's global mesh; ``parallel/mesh.make_mesh``).  Every rank
    calls it the first time in a world (making a mesh is collective)."""
    return _mesh("world", (size(),), (AXIS,))


def hierarchical_mesh():
    """The world as a 2-D ``(cross, local)`` ``DeviceMesh``, hosts by
    ranks within a host (the reference's hierarchical mesh).  Collective
    the first time in a world, as :func:`mesh`."""
    return _mesh("hierarchical", (cross_size(), local_size()),
                 (CROSS_AXIS, LOCAL_AXIS))


def in_spmd() -> bool:
    """False: the port has no SPMD region; every rank is a process
    running the same code (the module docstring)."""
    return False


def is_initialized() -> bool:
    return _world is not None


def _require_init() -> _World:
    if _world is None:
        raise NotInitializedError()
    return _world


def device() -> torch.device:
    """The device this rank computes on."""
    return _require_init().device


def backend() -> str:
    return _require_init().backend


def rank() -> int:
    return _require_init().rank


def size() -> int:
    return _require_init().size


def local_rank() -> int:
    """Rank within the host (reference basics.py:152-160)."""
    w = _require_init()
    return w.rank % w.local_size


def local_size() -> int:
    return _require_init().local_size


def cross_rank() -> int:
    """Index of this rank's host."""
    w = _require_init()
    return w.rank // w.local_size


def cross_size() -> int:
    w = _require_init()
    return w.size // w.local_size


# One process drives one card, so process and rank coincide.
process_rank = rank
process_size = size


def is_homogeneous() -> bool:
    _require_init()
    return True


# --- capability probes (reference horovod/common/basics.py:83-150) ----------
def mpi_enabled() -> bool:
    return False


def mpi_built() -> bool:
    return dist.is_mpi_available()


def gloo_enabled() -> bool:
    return _world is not None and "gloo" in _world.backend


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> bool:
    return torch.cuda.is_available() and dist.is_nccl_available()


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()


def rocm_built() -> bool:
    return torch.version.hip is not None


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False
