"""Workers for the launcher's tests: ``python torch_launch_tasks.py
<task> <workdir>`` under ``python -m horovod_tpu_torch.run -np N``, on
the CPU, identity and wiring from the launcher's environment; and the
functions the tests hand to function mode (``run(fn, np=...)``).

* ``train`` — the MLP through ``make_train_step`` (fused SGD, 3 steps)
  on this rank's shard over gloo; each rank pushes its final snapshot
  (``stop_pusher``), and after a barrier rank 0 reads the launcher's
  server (``metrics`` scope, ``GET /metrics``, ``GET /health``) into
  ``<workdir>/train.server.json``; every rank writes its losses and
  parameters to ``<workdir>/train.<rank>.json``.
* ``fail`` — rank 1 exits 1 right after joining; rank 0 waits at the
  abort seam the train step and the eager dispatch call first
  (``heartbeat.maybe_raise_abort``; entering a collective with the dead
  rank would fail in gloo instead) until the launcher's abort flag
  surfaces there as ``HorovodAbortError``, writing when it saw it to
  ``<workdir>/fail.0.json`` (rank 1 writes when it left to
  ``fail.1.json``).
* ``elastic`` — under ``--elastic``: the MLP trained ``ELASTIC_STEPS``
  steps inside ``elastic.run`` with an ``ElasticState`` re-synced at each
  epoch; the fault spec of the test ends one worker mid-run, and the
  survivors rebuild into the smaller world and go on.  Each worker
  writes ``(step, loss, world size, epoch)`` of every step it finished
  to ``<workdir>/elastic.<worker>.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def _mlp_step():
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import MLP
    from horovod_tpu_torch.optim.fused_update import fused_sgd

    torch.manual_seed(0)
    model = MLP(12, (16, 6))
    opt = fused_sgd(0.1, momentum=0.9)
    step = training.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                    optimizer=opt, loss_fetch_steps=0)
    return step, training.init_train_state(model, opt)


def _shard(rank: int):
    rng = np.random.default_rng(rank)
    x = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 6, 8))
    return x, y


def _task_train(workdir: Path) -> None:
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.metrics import push
    from horovod_tpu_torch.run import http_client

    htt.init(device="cpu")
    rank = htt.rank()
    step, state = _mlp_step()
    x, y = _shard(rank)
    losses = []
    for _ in range(3):
        state, loss = step(state, x, y)
        losses.append(loss.item())
    push.stop_pusher()                     # this rank's final snapshot
    htt.allreduce(torch.zeros(1))          # ... and every other rank's
    if rank == 0:
        addr = os.environ["HVD_METRICS_KV_ADDR"]
        port = int(os.environ["HVD_METRICS_KV_PORT"])
        secret = bytes.fromhex(os.environ["HVD_METRICS_SECRET"])
        scope = http_client.get_scope(addr, port, "metrics", secret=secret)
        (workdir / "train.server.json").write_text(json.dumps({
            "metrics": {k: json.loads(v)
                        for k, v in scope["entries"].items()},
            "prometheus": http_client.get_metrics(addr, port, secret=secret),
            "health": http_client.get_health(addr, port, secret=secret)}))
    (workdir / f"train.{rank}.json").write_text(json.dumps({
        "losses": losses, "size": htt.size(),
        "device": str(htt.device()),
        "params": {k: v.tolist() for k, v in state.params.items()}}))
    htt.shutdown()


def _task_fail(workdir: Path) -> None:
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.elastic import heartbeat

    htt.init(device="cpu")
    if htt.rank() == 1:
        (workdir / "fail.1.json").write_text(json.dumps(
            {"exited_at": time.time()}))
        os._exit(1)
    try:
        while True:
            heartbeat.maybe_raise_abort()
            time.sleep(0.01)
    except htt.HorovodAbortError as e:
        (workdir / "fail.0.json").write_text(json.dumps(
            {"aborted_at": time.time(), "error": str(e)}))
        raise


ELASTIC_STEPS = 8


def _task_elastic(workdir: Path) -> None:
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.elastic import membership

    htt.init(device="cpu")
    worker = membership.worker_id()
    step, state = _mlp_step()
    es = htt.ElasticState(str(workdir / "ck"), state)
    log = []

    def train(es):
        st = es.state
        while st.step < ELASTIC_STEPS:
            x, y = _shard(htt.rank())
            st, loss = step(st, x, y)
            es.state, es.step = st, st.step
            log.append((st.step, loss.item(), htt.size(),
                        membership.current_epoch()))
            (workdir / f"elastic.{worker}.json").write_text(json.dumps(log))
            time.sleep(0.05)  # leave the driver a step to see a death in
        return st

    membership.run(train, es)
    htt.shutdown()


def allreduce_rank():
    """Function mode: join the job, sum ``rank + 1`` over it, and return
    ``(rank, size, sum)``."""
    import horovod_tpu_torch as htt

    htt.init(device="cpu")
    total = htt.allreduce(torch.full((2,), htt.rank() + 1.0), op=htt.Sum)
    out = (htt.rank(), htt.size(), total.tolist())
    htt.shutdown()
    return out


if __name__ == "__main__":
    task, workdir = sys.argv[1], Path(sys.argv[2])
    {"train": _task_train, "fail": _task_fail,
     "elastic": _task_elastic}[task](workdir)
