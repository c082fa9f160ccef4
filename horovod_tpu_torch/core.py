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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .utils import env as env_util
from .utils.logging import get_logger

log = get_logger(__name__)

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
        dist.init_process_group(backend, init_method=f"tcp://{addr}",
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


def shutdown() -> None:
    """Leave the process group (``hvd.shutdown()``)."""
    global _world
    if _world is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _world = None


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
