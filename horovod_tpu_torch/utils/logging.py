"""Leveled logging configured from HVD_LOG_LEVEL / HVD_LOG_HIDE_TIME
(the same rules as ``horovod_tpu/utils/logging.py``, under the
``horovod_tpu_torch`` logger)."""

from __future__ import annotations

import logging
import sys

from . import env as env_util

_ROOT = "horovod_tpu_torch"

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}

logging.addLevelName(_LEVELS["trace"], "TRACE")


def _configure(root: logging.Logger) -> None:
    level_str = env_util.get_str(env_util.HVD_LOG_LEVEL, "warning")
    level = _LEVELS.get(level_str.strip().lower(), logging.WARNING)
    hide_time = env_util.get_bool(env_util.HVD_LOG_HIDE_TIME)
    fmt = "[%(levelname)s] hvd: %(message)s" if hide_time else (
        "%(asctime)s [%(levelname)s] hvd: %(message)s"
    )
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(fmt))
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        _configure(root)
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
