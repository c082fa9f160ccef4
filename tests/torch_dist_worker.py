"""Multi-process drives of horovod_tpu_torch for the tests: one process
per rank on a gloo group over localhost, identity from the same HVD_*
environment a launcher sets.

``launch(task, nproc, workdir)`` starts ``nproc`` copies of this file and
waits for them; each rank writes ``<workdir>/<task>.<rank>.npz``.  Inputs
the task needs are read from ``<workdir>/inputs.npz``.

The job's rendezvous cannot be another job's: rank 0 binds a free port
itself (port 0) and hands it to the other ranks in
``<workdir>/<task>.port``, so no port is freed and taken again in between
(tests running side by side once met at one port that way).  When a rank
fails or the job outlives its time, every rank is killed and the
assertion holds all their output.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
#: seconds a rank waits for rank 0's port file (core.init then waits
#: HVD_START_TIMEOUT, 60 by default, for the other ranks)
START_TIMEOUT = 60.0


def launch(task: str, nproc: int, workdir, local_size: int = None,
           timeout: float = 120.0):
    """Runs the job; returns the ranks' exit codes (all 0) and outputs.
    Raises ``AssertionError`` with every rank's output when a rank exits
    non-zero or the job is not done within ``timeout`` seconds, after
    killing the ranks still running."""
    workdir = Path(workdir)
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
        "HVD_NUM_PROCESSES": str(nproc),
        "OMP_NUM_THREADS": "1",
    })
    env.pop("HVD_COORDINATOR_ADDR", None)
    if local_size is not None:
        env["HVD_LOCAL_SIZE"] = str(local_size)
    (workdir / f"{task}.port").unlink(missing_ok=True)
    logs = [workdir / f"{task}.{r}.log" for r in range(nproc)]
    procs = []
    for r in range(nproc):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, task, str(workdir)],
                env={**env, "HVD_PROCESS_ID": str(r)}, stdout=out,
                stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll()]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"not done after {timeout} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    outs = [log.read_text() for log in logs]
    if failed or any(rcs):
        raise AssertionError(
            f"{task} job of {nproc} ranks: {failed or 'a rank failed'}; "
            f"exit codes {rcs}\n" + "\n".join(
                f"--- rank {r} ---\n{out}" for r, out in enumerate(outs)))
    return rcs, outs


def _rendezvous(workdir: Path, task: str):
    """Points HVD_COORDINATOR_ADDR at rank 0's port.  Rank 0 serves the
    job's store on a port the system picks and writes it to the port
    file (core.init joins this server); the others wait for the file.
    Returns rank 0's store, which must outlive the job."""
    import torch.distributed as dist

    rank, size = int(os.environ["HVD_PROCESS_ID"]), \
        int(os.environ["HVD_NUM_PROCESSES"])
    path = workdir / f"{task}.port"
    store = None
    if rank == 0:
        store = dist.TCPStore(
            "localhost", 0, size, is_master=True, wait_for_workers=False,
            multi_tenant=True,
            timeout=datetime.timedelta(seconds=START_TIMEOUT))
        tmp = path.with_suffix(".tmp")
        tmp.write_text(str(store.port))
        tmp.rename(path)
    else:
        deadline = time.monotonic() + START_TIMEOUT
        while not path.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {rank}: no {path.name} from rank "
                                   f"0 after {START_TIMEOUT} s")
            time.sleep(0.02)
    os.environ["HVD_COORDINATOR_ADDR"] = f"localhost:{path.read_text()}"
    return store


# ---------------------------------------------------------------------------
def fusion_inputs(rank: int):
    """Rank ``rank``'s gradients for the fusion task: float32 leaves of
    assorted shapes, values drawn from a per-rank seed."""
    rng = np.random.default_rng(100 + rank)
    shapes = [(7, 5), (5,), (300,), (3, 3, 2, 4), (1,), (64, 33)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _task_core(workdir: Path):
    import horovod_tpu_torch as htt

    htt.init(device="cpu")
    out = {k: getattr(htt, k)() for k in
           ("rank", "size", "local_rank", "local_size", "cross_rank",
            "cross_size")}
    htt.shutdown()
    return out


def _task_fusion(workdir: Path):
    import torch

    import horovod_tpu_torch as htt

    htt.init(device="cpu")
    mine = [torch.from_numpy(a) for a in fusion_inputs(htt.rank())]
    out = {}
    for op in (htt.Average, htt.Sum):
        for thr in (1, 1 << 10, 1 << 26):
            red = htt.fused_allreduce(mine, op=op, threshold_bytes=thr)
            for i, t in enumerate(red):
                out[f"{op}_{thr}_{i}"] = t.numpy()
    tree = {f"leaf{i}": t for i, t in enumerate(mine)}
    for k, t in htt.allreduce_pytree(tree).items():
        out[f"tree_{k}"] = t.numpy()
    out["loss"] = htt.allreduce(torch.tensor(float(htt.rank()))).numpy()
    htt.shutdown()
    return out


def _task_train_mlp(workdir: Path):
    """3 steps of the MLP on this rank's shard, from the reference's
    initial weights (inputs.npz: params as flax-layout arrays, x, y)."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as htt
    from horovod_tpu_torch.convert import (
        canonical_layouts, export_flax_variables, load_flax_variables,
    )
    from horovod_tpu_torch.models import MLP

    inputs = dict(np.load(workdir / "inputs.npz"))
    htt.init(device="cpu")
    params = {k[len("p:"):]: v for k, v in inputs.items()
              if k.startswith("p:")}
    nested: dict = {}
    for path, v in params.items():
        a, b = path.split("/")
        nested.setdefault(a, {})[b] = v
    model = MLP(int(inputs["in_features"]),
                tuple(int(f) for f in inputs["features"]))
    load_flax_variables(model, nested)
    opt = htt.fused_sgd(0.1, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, loss_fetch_steps=0)
    state = htt.init_train_state(model, opt)
    x = htt.shard_batch(torch.from_numpy(inputs["x"]))
    y = htt.shard_batch(torch.from_numpy(inputs["y"]).long())
    losses = []
    for _ in range(3):
        state, loss = step(state, x, y)
        losses.append(loss.item())
    out = {f"p:{k}": v for k, v in export_flax_variables(
        state.params, canonical_layouts(model)).items()}
    out["losses"] = np.asarray(losses)
    htt.shutdown()
    return out


#: the process set of the collectives task, in a world of 4
COLLECTIVE_SET = (0, 2)
#: the collectives task's allgatherv rows per rank, padded to 3
ALLGATHERV_ROWS = (3, 0, 2, 1)


def collective_inputs(rank: int) -> dict:
    """Rank ``rank``'s inputs for the collectives task, from a per-rank
    seed: ``x`` [4, 3] (four rows, so it splits among 4 ranks and among
    the 2 of the set), three leaves ``g0``-``g2`` for the grouped
    allreduce, and ``v`` [3, 2] for allgatherv."""
    rng = np.random.default_rng(200 + rank)
    return {"x": rng.normal(size=(4, 3)).astype(np.float32),
            "g0": rng.normal(size=(3,)).astype(np.float32),
            "g1": rng.normal(size=(4, 2)).astype(np.float32),
            "g2": rng.normal(size=(5,)).astype(np.float32),
            "v": rng.normal(size=(3, 2)).astype(np.float32)}


def collective_cases(htt, ps, t: dict, rows):
    """``{case: () -> tensor or list of tensors}``: every collective of
    the port, over the whole world and over the process set ``ps``;
    ``t`` holds this rank's inputs as tensors, ``rows`` its allgatherv
    valid rows (an int)."""
    import torch

    grads = {"a": t["g0"], "b": {"c": t["g1"]}}
    return {
        "allreduce_sum": lambda: htt.allreduce(t["x"], op=htt.Sum),
        "allreduce_average": lambda: htt.allreduce(t["x"]),
        "allreduce_min": lambda: htt.allreduce(t["x"], op=htt.Min),
        "allreduce_max": lambda: htt.allreduce(t["x"], op=htt.Max),
        "allreduce_scaled": lambda: htt.allreduce(
            t["x"], prescale_factor=0.5, postscale_factor=3.0),
        "allreduce_set_sum": lambda: htt.allreduce(
            t["x"], op=htt.Sum, process_set=ps),
        "allreduce_set_scaled": lambda: htt.allreduce(
            t["x"], process_set=ps, prescale_factor=0.5,
            postscale_factor=3.0),
        "grouped_allreduce": lambda: htt.grouped_allreduce(
            [t["g0"], t["g1"], t["g2"]], op=htt.Sum, threshold_bytes=32),
        "grouped_allreduce_set": lambda: htt.grouped_allreduce(
            [t["g0"], t["g1"], t["g2"]], process_set=ps),
        "allreduce_gradients": lambda: (lambda r: [r["a"], r["b"]["c"]])(
            htt.allreduce_gradients(grads)),
        "allgather": lambda: htt.allgather(t["x"]),
        "allgather_set": lambda: htt.allgather(t["x"], process_set=ps),
        "allgatherv": lambda: list(htt.allgatherv(
            t["v"], valid_rows=rows, max_rows=3)),
        "allgatherv_set": lambda: list(htt.allgatherv(
            t["v"], valid_rows=torch.tensor(rows), max_rows=3,
            process_set=ps)),
        "broadcast": lambda: htt.broadcast(t["x"], root_rank=1),
        "broadcast_set": lambda: htt.broadcast(t["x"], root_rank=2,
                                               process_set=ps),
        "alltoall": lambda: htt.alltoall(t["x"]),
        "alltoall_set": lambda: htt.alltoall(t["x"], process_set=ps),
        "reducescatter": lambda: htt.reducescatter(t["x"]),
        "reducescatter_average": lambda: htt.reducescatter(
            t["x"], op=htt.Average),
        "reducescatter_set": lambda: htt.reducescatter(t["x"],
                                                       process_set=ps),
    }


def _task_collectives(workdir: Path):
    """Every case of :func:`collective_cases` on this rank; a list result
    is stored as ``<case>/<i>``, and each input as ``input/<name>``."""
    import torch

    import horovod_tpu_torch as htt

    htt.init(device="cpu")
    inputs = collective_inputs(htt.rank())
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    ps = htt.ProcessSet(COLLECTIVE_SET)
    out = {f"input/{k}": v for k, v in inputs.items()}
    cases = collective_cases(htt, ps, t, ALLGATHERV_ROWS[htt.rank()])
    for name, run in cases.items():
        got = run()
        for i, g in enumerate(got if isinstance(got, list) else [got]):
            out[f"{name}/{i}"] = g.numpy()
    for k, v in inputs.items():
        if not np.array_equal(t[k].numpy(), v):
            raise AssertionError(f"a collective changed its input {k}")
    htt.shutdown()
    return out


def _task_fail(workdir: Path):
    """Rank 1 fails before it joins; rank 0 waits for it in init."""
    import horovod_tpu_torch as htt

    if os.environ["HVD_PROCESS_ID"] == "1":
        raise RuntimeError("planted failure of rank 1")
    htt.init(device="cpu")
    return {}


TASKS = {"core": _task_core, "fail": _task_fail, "fusion": _task_fusion,
         "train_mlp": _task_train_mlp, "collectives": _task_collectives}


def main():
    task, workdir = sys.argv[1], Path(sys.argv[2])
    store = _rendezvous(workdir, task)
    out = TASKS[task](workdir)
    del store
    rank = os.environ["HVD_PROCESS_ID"]
    np.savez(workdir / f"{task}.{rank}.npz", **out)


if __name__ == "__main__":
    main()
