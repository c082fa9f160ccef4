"""ctypes loader for the native runtime core (``build/libhvdcore.so``):
the timeline half of ``horovod_tpu/runtime/native.py``.

The library is the repository's ``csrc/`` (``timeline.cc`` with the
controller, ring and autotuner sources beside it), compiled on first use
with ``make -C csrc`` (``g++``, no CUDA) into
``build/horovod_tpu_torch/libhvdcore.so`` inside the checkout (beside the
kernels' library, apart from the JAX package's own build of the same
sources) and rebuilt when a source is newer; concurrent processes take
turns on a file lock, and the library appears under its name only once
linked.  The port binds
only the timeline writer's C API — ``hvd_timeline_open``,
``hvd_timeline_event``, ``hvd_timeline_close`` — used by
``timeline/timeline.py``.  A machine without ``g++`` or ``make`` gets
the Python writer instead (``timeline.writer_kind`` says which is open).
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
    """Load (building if stale) and type the timeline's C API."""
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
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except Exception as e:  # noqa: BLE001
        log.warning("native core unavailable: %s", e)
        return False
