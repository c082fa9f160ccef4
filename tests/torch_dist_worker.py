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


def _train_mlp(htt, inputs: dict, steps: int, **kw):
    """``steps`` steps of the MLP on this rank's shard, from the
    reference's initial weights (inputs: params as flax-layout arrays
    ``p:<path>``, x, y); ``kw`` go to make_train_step, and a
    ``compression`` also to init_train_state.  Returns the flax-layout
    parameters as ``p:<path>`` and the losses."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.convert import (
        canonical_layouts, export_flax_variables, load_flax_variables,
    )
    from horovod_tpu_torch.models import MLP

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
                               optimizer=opt, loss_fetch_steps=0, **kw)
    state = htt.init_train_state(model, opt,
                                 compression=kw.get("compression"))
    x = htt.shard_batch(torch.from_numpy(inputs["x"]))
    y = htt.shard_batch(torch.from_numpy(inputs["y"]).long())
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, y)
        losses.append(loss.item())
    out = {f"p:{k}": v for k, v in export_flax_variables(
        state.params, canonical_layouts(model)).items()}
    out["losses"] = np.asarray(losses)
    return out


def _task_train_mlp(workdir: Path):
    """3 steps of the MLP on this rank's shard."""
    import horovod_tpu_torch as htt

    inputs = dict(np.load(workdir / "inputs.npz"))
    htt.init(device="cpu")
    out = _train_mlp(htt, inputs, 3)
    htt.shutdown()
    return out


#: the make_train_step options the train_wire task runs, as
#: (compression name or None, other keywords)
WIRE_TRAIN = {
    "ef_int8": ("ef_int8", {}),
    "two_level_int8": ("int8", {"two_level": True}),
    "hierarchical": (None, {"hierarchical": True}),
    "adasum_hierarchical": (None, {"op": "Adasum", "hierarchical": True}),
}


def _task_train_wire(workdir: Path):
    """2 steps of the MLP for each of WIRE_TRAIN's options."""
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops.compression import Compression

    inputs = dict(np.load(workdir / "inputs.npz"))
    htt.init(device="cpu")
    out = {}
    for name, (comp, kw) in WIRE_TRAIN.items():
        if comp is not None:
            kw = {**kw, "compression": Compression.lookup(comp)}
        for k, v in _train_mlp(htt, inputs, 2, **kw).items():
            out[f"{name}/{k}"] = v
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


# ---------------------------------------------------------------------------
# the wire tier: compression, Adasum, hierarchical reduction, sparse
# slices, the process plane and the torch frontend (4 ranks, 2 a host)
# ---------------------------------------------------------------------------
#: the EF leaves' shapes, and the steps the EF task runs
WIRE_SHAPES = ((17,), (5, 3))
WIRE_STEPS = 3
#: the wire task's process set, and one whose size is no power of two
WIRE_SET = (0, 2)
WIRE_ODD_SET = (0, 1, 2)
#: the sparse rows each rank holds (the same count on every rank, as the
#: reference's SPMD allgather takes them)
SPARSE_ROWS = 3


def wire_inputs(rank: int) -> dict:
    """Rank ``rank``'s inputs for the wire task, from a per-rank seed:
    ``ef{i}`` the EF gradients (WIRE_SHAPES), ``v`` [11] (Adasum), ``x``
    [7] (an odd length, so the hierarchical scatter pads), ``sv`` and
    ``si`` the sparse rows of a [6, 3] table (SPARSE_ROWS of them),
    ``g`` [9, 3] rows for the frontend's allgather (rank + 1 of them)."""
    rng = np.random.default_rng(300 + rank)
    out = {f"ef{i}": rng.normal(size=s).astype(np.float32)
           for i, s in enumerate(WIRE_SHAPES)}
    k = SPARSE_ROWS
    out.update(v=rng.normal(size=(11,)).astype(np.float32),
               x=rng.normal(size=(7,)).astype(np.float32),
               sv=rng.normal(size=(k, 3)).astype(np.float32),
               si=rng.integers(0, 6, size=(k,)).astype(np.int64),
               g=rng.normal(size=(rank + 1, 3)).astype(np.float32))
    return out


class MaxCounter:
    """Counts the MAX all-reduces issued while active."""

    def __enter__(self):
        import torch.distributed as dist

        self.n = 0
        self._dist, self._call = dist, dist.all_reduce

        def counting(t, op=dist.ReduceOp.SUM, *a, **kw):
            if op == dist.ReduceOp.MAX:
                self.n += 1
            return self._call(t, op, *a, **kw)

        dist.all_reduce = counting
        return self

    def __exit__(self, *exc):
        self._dist.all_reduce = self._call


def _raises(fn, exc, match: str) -> bool:
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False


def _task_wire(workdir: Path):
    import torch

    import horovod_tpu_torch as htt
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import eager
    from horovod_tpu_torch.elastic.join import join_allreduce, join_count
    from horovod_tpu_torch.ops.compression import (
        Compression, ErrorFeedback, FP8Compressor,
    )
    from horovod_tpu_torch.ops.sparse import (
        IndexedSlices, allreduce_indexed_slices,
    )
    from horovod_tpu_torch.parallel.hierarchical import (
        FALLBACKS, hierarchical_allgather, hierarchical_allreduce,
        process_stage_plan, two_level_allreduce,
    )

    htt.init(device="cpu")
    r = htt.rank()
    inputs = wire_inputs(r)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    # error feedback, int8, over 3 steps of the same gradients
    grads = [t[f"ef{i}"] for i in range(len(WIRE_SHAPES))]
    res = [torch.zeros_like(g) for g in grads]
    ef = ErrorFeedback(Compression.int8)
    with MaxCounter() as maxes:
        for s in range(WIRE_STEPS):
            red, res = htt.fused_allreduce(grads, compression=ef,
                                           residuals=res)
            for i, (m, rr) in enumerate(zip(red, res)):
                out[f"ef/{s}/mean{i}"] = m.numpy()
                out[f"ef/{s}/res{i}"] = rr.numpy()
    out["ef/max_allreduces"] = np.asarray(maxes.n)
    out["ef/fp8_refused_on_gloo"] = np.asarray(_raises(
        lambda: htt.fused_allreduce(grads, compression=FP8Compressor),
        RuntimeError, "gloo"))
    # Adasum: flat, hierarchical, over a set; a set of 3 raises
    ps = htt.ProcessSet(WIRE_SET)
    odd = htt.ProcessSet(WIRE_ODD_SET)
    out["adasum/flat"] = htt.allreduce(t["v"], op=htt.Adasum).numpy()
    out["adasum/hier"] = htt.allreduce(t["v"], op=htt.Adasum,
                                       hierarchical=True).numpy()
    out["adasum/set"] = htt.allreduce(t["v"], op=htt.Adasum,
                                      process_set=ps).numpy()
    out["adasum/odd_set_raises"] = np.asarray(_raises(
        lambda: htt.allreduce(t["v"], op=htt.Adasum, process_set=odd),
        ValueError, "power-of-two"))
    # hierarchical and two-level reductions
    out["hier/average"] = hierarchical_allreduce(t["x"]).numpy()
    out["hier/sum"] = hierarchical_allreduce(t["x"], op=htt.Sum).numpy()
    out["hier/allreduce"] = htt.allreduce(t["x"], hierarchical=True).numpy()
    before = FALLBACKS["two_level"]
    out["two_level/int8"] = two_level_allreduce(
        t["x"], compression=Compression.int8).numpy()
    out["two_level/ef_int8"] = htt.allreduce(
        t["x"], compression=ErrorFeedback(Compression.int8),
        two_level=True).numpy()
    out["two_level/sum"] = two_level_allreduce(t["x"], op=htt.Sum).numpy()
    out["two_level/fallbacks"] = np.asarray(FALLBACKS["two_level"] - before)
    out["hier/allgather"] = hierarchical_allgather(t["x"][None]).numpy()
    out["hier/plan"] = np.asarray([[s.peers for s in process_stage_plan()]])
    # sparse slices, alone and inside a tree with a residual
    sl = IndexedSlices(t["sv"], t["si"], (6, 3))
    red = allreduce_indexed_slices(sl)
    out["sparse/values"], out["sparse/indices"] = (red.values.numpy(),
                                                   red.indices.numpy())
    sparse_res = torch.full((6, 3), 7.0)
    tree, res_tree = htt.allreduce_pytree(
        {"emb": sl, "w": t["x"]}, compression=ef,
        residual={"emb": sparse_res, "w": torch.zeros(7)})
    out["sparse/tree_w"] = tree["w"].numpy()
    out["sparse/tree_values"] = tree["emb"].values.numpy()
    out["sparse/res_untouched"] = np.asarray(res_tree["emb"] is sparse_res)
    # join: rank 3 has run out of data
    out["join/average"] = join_allreduce(t["x"], r != 3).numpy()
    out["join/count"] = join_count(r != 3).numpy()
    # the process plane
    out["eager/allreduce"] = eager.process_allreduce(inputs["x"])
    out["eager/allgather"] = eager.process_allgather(inputs["g"])
    out["eager/broadcast"] = eager.process_broadcast(inputs["x"], 1)
    out["eager/objects"] = np.asarray(eager.allgather_object(r * 10))
    out["eager/object"] = np.asarray(eager.broadcast_object(
        {"from": r}, root_rank=2, name="resume")["from"])
    # the torch frontend
    h = hvd_torch.allreduce_async(t["x"], op=hvd_torch.Sum)
    while not hvd_torch.poll(h):
        time.sleep(0.001)
    out["frontend/sum"] = hvd_torch.synchronize(h).numpy()
    out["frontend/average"] = hvd_torch.allreduce(t["x"]).numpy()
    out["frontend/max"] = hvd_torch.allreduce(t["x"], op=htt.Max).numpy()
    out["frontend/fp16"] = hvd_torch.allreduce(
        t["x"], compression=hvd_torch.Compression.fp16).numpy()
    inplace = t["x"].clone()
    hvd_torch.allreduce_(inplace, average=False)
    out["frontend/inplace_sum"] = inplace.numpy()
    out["frontend/allgather"] = hvd_torch.allgather(t["g"]).numpy()
    out["frontend/broadcast"] = hvd_torch.broadcast(t["x"], 1).numpy()
    out["frontend/object"] = np.asarray(hvd_torch.broadcast_object(
        r + 100, root_rank=3, name="epoch"))
    out.update(_frontend_training(hvd_torch, r))
    for k, v in inputs.items():
        if not np.array_equal(t[k].numpy(), v):
            raise AssertionError(f"a collective changed its input {k}")
    htt.shutdown()
    return out


#: the frontend's tiny model: Linear(4, 3), its data per rank
FRONTEND_IN, FRONTEND_OUT = 4, 3


def frontend_data(rank: int):
    rng = np.random.default_rng(400 + rank)
    return (rng.normal(size=(5, FRONTEND_IN)).astype(np.float32),
            rng.normal(size=(5, FRONTEND_OUT)).astype(np.float32))


def _frontend_training(hvd_torch, rank: int) -> dict:
    """The frontend's optimizers on a Linear(4, 3) whose weights differ
    by rank until broadcast from rank 0: 2 SGD-momentum steps through
    DistributedOptimizer (one pass a step, then 2 passes a step), one
    Adasum delta step, and the optimizer state broadcast."""
    import torch

    out = {}
    x, y = (torch.from_numpy(a) for a in frontend_data(rank))
    for name, kw, passes in (("sgd", {}, 1),
                             ("bpps2", {"backward_passes_per_step": 2}, 2),
                             ("adasum", {"op": hvd_torch.Adasum}, 1)):
        torch.manual_seed(rank)
        model = torch.nn.Linear(FRONTEND_IN, FRONTEND_OUT)
        hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(), **kw)
        hvd_torch.broadcast_optimizer_state(opt, root_rank=0)
        for _ in range(2):
            opt.zero_grad()
            for _ in range(passes):
                loss = torch.nn.functional.mse_loss(model(x), y)
                loss.backward()
                opt.step()
        out[f"train/{name}/weight"] = model.weight.detach().numpy()
        out[f"train/{name}/bias"] = model.bias.detach().numpy()
    return out


def _task_fail(workdir: Path):
    """Rank 1 fails before it joins; rank 0 waits for it in init."""
    import horovod_tpu_torch as htt

    if os.environ["HVD_PROCESS_ID"] == "1":
        raise RuntimeError("planted failure of rank 1")
    htt.init(device="cpu")
    return {}


TASKS = {"core": _task_core, "fail": _task_fail, "fusion": _task_fusion,
         "train_mlp": _task_train_mlp, "collectives": _task_collectives,
         "wire": _task_wire, "train_wire": _task_train_wire}


def main():
    task, workdir = sys.argv[1], Path(sys.argv[2])
    store = _rendezvous(workdir, task)
    out = TASKS[task](workdir)
    del store
    rank = os.environ["HVD_PROCESS_ID"]
    np.savez(workdir / f"{task}.{rank}.npz", **out)


if __name__ == "__main__":
    main()
