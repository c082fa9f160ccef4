"""ctypes loader for the native runtime core (``build/libhvdcore.so``):
the port of ``horovod_tpu/runtime/native.py``.

The library is the repository's ``csrc/`` (``timeline.cc`` with the
controller, ring and autotuner sources beside it), compiled on first use
with ``make -C csrc`` (``g++``, no CUDA) into
``build/horovod_tpu_torch/libhvdcore.so`` inside the checkout (beside the
kernels' library, apart from the JAX package's own build of the same
sources) and rebuilt when a source is newer; concurrent processes take
turns on a file lock, and the library appears under its name only once
linked.  The port binds the timeline writer's C API
(``hvd_timeline_open``, ``hvd_timeline_event``, ``hvd_timeline_close``,
used by ``timeline/timeline.py``), the negotiation controller's
(``hvd_server_*`` and ``hvd_client_*``, ``csrc/controller.cc``, used by
``runtime/controller.py``), the peer ring's (``hvd_ring_*``,
``csrc/ring.cc``, used by ``runtime/ring.py``) and the autotuner's
(``hvd_tuner_*``, ``csrc/autotune.cc``, used by ``optim/autotune.py``;
with the GP's ``hvd_gp_*``, which the tests hold against the NumPy GP).
A machine without ``g++`` or ``make`` gets the Python writer and the
NumPy tuner instead (``timeline.writer_kind`` says which writer is
open); the controller and the ring have no such stand-in, so
``HVD_CONTROLLER=native`` raises there (``core.init``).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..utils.logging import get_logger

log = get_logger(__name__)

_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = _ROOT / "build" / "horovod_tpu_torch"
SO_PATH = BUILD_DIR / "libhvdcore.so"
CSRC = _ROOT / "csrc"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _sources_newer():
            return
        log.info("building native core: make -C %s", CSRC)
        tmp = SO_PATH.with_name(f"{SO_PATH.name}.{os.getpid()}.tmp")
        subprocess.run(["make", "-B", "-C", str(CSRC), f"OUT={tmp}"],
                       check=True, capture_output=True)
        os.replace(tmp, SO_PATH)


def _sources_newer() -> bool:
    if not SO_PATH.exists():
        return True
    so_mtime = SO_PATH.stat().st_mtime
    return any(f.suffix in (".cc", ".h") and f.stat().st_mtime > so_mtime
               for f in CSRC.iterdir())


def load() -> ctypes.CDLL:
    """Load (building if stale) and type the C API."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _sources_newer():
            _build()
        lib = ctypes.CDLL(os.fspath(SO_PATH))
        lib.hvd_timeline_open.restype = ctypes.c_void_p
        lib.hvd_timeline_open.argtypes = [ctypes.c_char_p]
        lib.hvd_timeline_event.restype = None
        lib.hvd_timeline_event.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char, ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
        ]
        lib.hvd_timeline_close.restype = None
        lib.hvd_timeline_close.argtypes = [ctypes.c_void_p]

        # controller server
        lib.hvd_server_start.restype = ctypes.c_void_p
        lib.hvd_server_start.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_longlong, ctypes.c_double,
        ]
        lib.hvd_server_port.restype = ctypes.c_int
        lib.hvd_server_port.argtypes = [ctypes.c_void_p]
        for fn in ("hvd_server_cache_hits", "hvd_server_cycles",
                   "hvd_server_stall_warnings"):
            getattr(lib, fn).restype = ctypes.c_longlong
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.hvd_server_stop.restype = None
        lib.hvd_server_stop.argtypes = [ctypes.c_void_p]

        # controller client
        lib.hvd_client_connect.restype = ctypes.c_void_p
        lib.hvd_client_connect.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.hvd_client_submit.restype = ctypes.c_int
        lib.hvd_client_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ]
        lib.hvd_client_join.restype = ctypes.c_int
        lib.hvd_client_join.argtypes = [ctypes.c_void_p]
        lib.hvd_client_wait.restype = ctypes.c_int
        lib.hvd_client_wait.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.hvd_client_wait_join.restype = ctypes.c_int
        lib.hvd_client_wait_join.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.hvd_client_submit_data.restype = ctypes.c_int
        lib.hvd_client_submit_data.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ]
        lib.hvd_client_wait_data.restype = ctypes.c_int
        lib.hvd_client_wait_data.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_char_p, ctypes.c_int,
        ]
        lib.hvd_client_stats.restype = ctypes.c_int
        lib.hvd_client_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.hvd_client_close.restype = None
        lib.hvd_client_close.argtypes = [ctypes.c_void_p]
        lib.hvd_client_enable_order_stream.restype = None
        lib.hvd_client_enable_order_stream.argtypes = [ctypes.c_void_p]
        lib.hvd_client_next_negotiated.restype = ctypes.c_int
        lib.hvd_client_next_negotiated.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_char_p,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
        ]

        # peer ring data plane
        lib.hvd_ring_create.restype = ctypes.c_void_p
        lib.hvd_ring_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ]
        lib.hvd_ring_port.restype = ctypes.c_int
        lib.hvd_ring_port.argtypes = [ctypes.c_void_p]
        lib.hvd_ring_connect.restype = ctypes.c_int
        lib.hvd_ring_connect.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
        ]
        lib.hvd_ring_allreduce.restype = ctypes.c_int
        lib.hvd_ring_allreduce.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.hvd_ring_broadcast.restype = ctypes.c_int
        lib.hvd_ring_broadcast.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ]
        lib.hvd_ring_allgather.restype = ctypes.c_int
        lib.hvd_ring_allgather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong,
        ]
        lib.hvd_ring_close.restype = None
        lib.hvd_ring_close.argtypes = [ctypes.c_void_p]

        # the autotuner's state machine
        lib.hvd_tuner_create.restype = ctypes.c_void_p
        lib.hvd_tuner_create.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
        ]
        lib.hvd_tuner_record.restype = ctypes.c_int
        lib.hvd_tuner_record.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
        ]
        for name, res in (("x", ctypes.c_double),
                          ("category", ctypes.c_int),
                          ("frozen", ctypes.c_int),
                          ("best_score", ctypes.c_double),
                          ("last_score", ctypes.c_double),
                          ("samples_seen", ctypes.c_int)):
            fn = getattr(lib, f"hvd_tuner_{name}")
            fn.restype = res
            fn.argtypes = [ctypes.c_void_p]
        lib.hvd_tuner_destroy.restype = None
        lib.hvd_tuner_destroy.argtypes = [ctypes.c_void_p]

        # the GP alone (held against the NumPy GP by the tests)
        lib.hvd_gp_create.restype = ctypes.c_void_p
        lib.hvd_gp_create.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ]
        lib.hvd_gp_fit.restype = None
        lib.hvd_gp_fit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.hvd_gp_predict.restype = None
        lib.hvd_gp_predict.argtypes = [
            ctypes.c_void_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.hvd_gp_destroy.restype = None
        lib.hvd_gp_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except Exception as e:  # noqa: BLE001
        log.warning("native core unavailable: %s", e)
        return False
