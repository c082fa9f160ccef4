"""Worker-side stub for function mode: the port of
``horovod_tpu/run/task_fn.py`` (reference horovod/run/task_fn.py /
run_task.py: fetch the pickled fn from the KV store, execute, publish the
result)."""

from __future__ import annotations

import os
import pickle
import sys
import traceback

from .http_client import get_kv, put_kv


def main() -> int:
    addr = os.environ["HVD_RUN_KV_ADDR"]
    port = int(os.environ["HVD_RUN_KV_PORT"])
    secret = bytes.fromhex(os.environ["HVD_RUN_SECRET"])
    pid = os.environ["HVD_RUN_PID"]

    blob = get_kv(addr, port, "job", "fn", secret=secret, wait=True)
    assert blob is not None
    fn, args, kwargs = pickle.loads(blob)
    try:
        value = fn(*args, **kwargs)
        payload = {"value": value, "error": None}
        rc = 0
    except Exception:  # noqa: BLE001
        payload = {"value": None, "error": traceback.format_exc()}
        rc = 1
    # final metrics snapshot: short function-mode jobs end before any
    # push interval elapses, so the worker flushes its registry here and
    # the parent's GET /metrics sees every rank
    from ..metrics.push import push_snapshot
    from ..metrics.registry import registry

    if registry.enabled:
        push_snapshot(addr, port, int(pid), secret)
    put_kv(addr, port, "result", pid, pickle.dumps(payload), secret=secret)
    return rc


if __name__ == "__main__":
    sys.exit(main())
