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


def _train_mlp(htt, inputs: dict, steps: int, keep: dict = None, **kw):
    """``steps`` steps of the MLP on this rank's shard, from the
    reference's initial weights (inputs: params as flax-layout arrays
    ``p:<path>``, x, y); ``kw`` go to make_train_step, and a
    ``compression`` also to init_train_state.  Returns the flax-layout
    parameters as ``p:<path>`` and the losses; ``keep["step"]`` is the
    train step when ``keep`` is given."""
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
    if keep is not None:
        keep["step"] = step
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
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.parallel.hierarchical import (
        hierarchical_allgather, hierarchical_allreduce, process_stage_plan,
        two_level_allreduce,
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
    before = metrics.TWO_LEVEL_FALLBACKS.get()
    out["two_level/int8"] = two_level_allreduce(
        t["x"], compression=Compression.int8).numpy()
    out["two_level/ef_int8"] = htt.allreduce(
        t["x"], compression=ErrorFeedback(Compression.int8),
        two_level=True).numpy()
    out["two_level/sum"] = two_level_allreduce(t["x"], op=htt.Sum).numpy()
    out["two_level/fallbacks"] = np.asarray(
        metrics.TWO_LEVEL_FALLBACKS.get() - before)
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


# ---------------------------------------------------------------------------
# model parallelism (parallel/): ring and Ulysses attention, tensor,
# pipeline and expert parallelism, the reference's drives, the benches'
# sequence parallelism
# ---------------------------------------------------------------------------
#: the ring task's shapes: batch, heads, head dim; the sequence is
#: RING_LOCAL a rank
RING_B, RING_H, RING_D, RING_LOCAL = 2, 4, 16, 8
#: the ring task's forms and impls, each causal and not
RING_FORMS = ("ring", "ulysses")
RING_IMPLS = ("xla", "flash")


def ring_inputs(world: int, batch: int = RING_B, seed: int = 31) -> dict:
    """q, k, v and the output cotangent g, ``[batch, RING_LOCAL · world,
    RING_H, RING_D]`` float32, from one seed."""
    rng = np.random.default_rng(seed)
    shape = (batch, RING_LOCAL * world, RING_H, RING_D)
    return {n: rng.normal(size=shape).astype(np.float32) for n in "qkvg"}


def _attend_and_grad(fn, inp: dict, block, **kw) -> dict:
    """``fn`` on this rank's ``block`` of q, k, v; then the backward of
    ``sum(out · g)``: the output and dq, dk, dv of the block."""
    import torch

    q, k, v = (torch.from_numpy(np.ascontiguousarray(inp[n][block]))
               .requires_grad_() for n in "qkv")
    out = fn(q, k, v, **kw)
    (out * torch.from_numpy(np.ascontiguousarray(inp["g"][block]))
     ).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _task_ring(workdir: Path):
    """Every form, impl and masking over the world, each rank one block
    of the sequence; then causal ring attention on a (dp, sp) = (2, 2)
    mesh over ``sp``, each dp row its half of the batch."""
    import torch

    import horovod_tpu_torch as htt
    from horovod_tpu_torch.parallel import ring_attention as ra
    from horovod_tpu_torch.parallel.mesh import make_mesh, use_mesh

    htt.init(device="cpu")
    r, n = htt.rank(), htt.size()
    out = {}
    inp = ring_inputs(n)
    seq = slice(r * RING_LOCAL, (r + 1) * RING_LOCAL)
    for form in RING_FORMS:
        fn = getattr(ra, f"{form}_attention")
        for impl in RING_IMPLS:
            for causal in (False, True):
                got = _attend_and_grad(fn, inp, (slice(None), seq),
                                       causal=causal, impl=impl)
                for k, v in got.items():
                    out[f"{form}/{impl}/{int(causal)}/{k}"] = v
    x = torch.zeros(1, RING_LOCAL, 3, RING_D)
    out["ulysses_heads_error"] = np.asarray(_raises(
        lambda: ra.ulysses_attention(x, x, x), ValueError, "heads 3"))
    inp = ring_inputs(2, batch=4, seed=32)
    mesh = make_mesh((2, 2), ("dp", "sp"))
    row, col = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    block = (slice(2 * row, 2 * row + 2),
             slice(col * RING_LOCAL, (col + 1) * RING_LOCAL))
    with use_mesh(mesh):
        for impl in RING_IMPLS:
            got = _attend_and_grad(ra.ring_attention, inp, block,
                                   causal=True, impl=impl, axis="sp")
            for k, v in got.items():
                out[f"dp_sp/{impl}/{k}"] = v
    htt.shutdown()
    return out


#: the tp task's MLP: in, hidden, out; batch; steps; SGD step size
TP_IN, TP_HIDDEN, TP_OUT, TP_BATCH, TP_STEPS, TP_LR = 16, 32, 8, 4, 3, 0.1


def tp_inputs() -> dict:
    rng = np.random.default_rng(41)
    return {"x": rng.normal(size=(TP_BATCH, TP_IN)).astype(np.float32),
            "y": rng.normal(size=(TP_BATCH, TP_OUT)).astype(np.float32),
            "full": rng.normal(size=(TP_BATCH, 8)).astype(np.float32),
            "w": rng.normal(size=(TP_BATCH, 8)).astype(np.float32)}


def _train_parallel_mlp(flax_params: dict, x, y, dp_axis) -> dict:
    """TP_STEPS SGD steps of a float32 ParallelMLP over ``tp`` from the
    reference's weights on the rows ``x``, ``y``, the mean squared error's
    gradients averaged over ``dp_axis`` (None: no data parallelism).
    Returns the losses (averaged likewise) and this rank's shards."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.convert import (
        canonical_params, parallel_mlp_params_from_flax,
    )
    from horovod_tpu_torch.parallel.mesh import axis_group
    from horovod_tpu_torch.parallel.tensor_parallel import ParallelMLP

    def mean(t):
        if dp_axis is None:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, group=axis_group(dp_axis))
        return t / dist.get_world_size(axis_group(dp_axis))

    model = ParallelMLP(TP_IN, TP_HIDDEN, TP_OUT, dtype=torch.float32,
                        axis="tp")
    tp = axis_group("tp")
    shards = parallel_mlp_params_from_flax(
        flax_params, rank=dist.get_rank(tp), size=dist.get_world_size(tp))
    params = canonical_params(model)
    with torch.no_grad():
        for name, t in params.items():
            t.copy_(shards[name])
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(TP_STEPS):
        loss = torch.mean((model(x) - y) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for t, g in zip(params.values(), grads):
                t -= TP_LR * mean(g)
        losses.append(mean(loss).item())
    out = {f"p:{k}": t.detach().numpy() for k, t in params.items()}
    out["losses"] = np.asarray(losses)
    return out


def _task_tp(workdir: Path):
    """On a (dp, tp) = (2, 2) mesh: each dp row trains the MLP at tp = 2
    on the whole batch ("tp"), then the rows split the batch and average
    their gradients ("dp_tp"); tp_constraint slices and gathers."""
    import torch

    import horovod_tpu_torch as htt
    from horovod_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from horovod_tpu_torch.parallel.tensor_parallel import tp_constraint

    inputs = dict(np.load(workdir / "inputs.npz"))
    flax_params = {k[len("p:"):]: v for k, v in inputs.items()
                   if k.startswith("p:")}
    data = tp_inputs()
    htt.init(device="cpu")
    mesh = make_mesh((2, 2), ("dp", "tp"))
    row = mesh.get_local_rank("dp")
    out = {}
    with use_mesh(mesh):
        for k, v in _train_parallel_mlp(flax_params, data["x"], data["y"],
                                        None).items():
            out[f"tp/{k}"] = v
        rows = slice(row * TP_BATCH // 2, (row + 1) * TP_BATCH // 2)
        for k, v in _train_parallel_mlp(flax_params, data["x"][rows],
                                        data["y"][rows], "dp").items():
            out[f"dp_tp/{k}"] = v
        full = torch.from_numpy(data["full"]).requires_grad_()
        block = tp_constraint(full, (None, "tp"), axis="tp")
        back = tp_constraint(block, (), axis="tp", current=(None, "tp"))
        (back * torch.from_numpy(data["w"])).sum().backward()
        out["constraint/block"] = block.detach().numpy()
        out["constraint/back"] = back.detach().numpy()
        out["constraint/grad"] = full.grad.numpy()
    htt.shutdown()
    return out


#: the pp task's pipeline: width, stages, microbatches, microbatch rows
#: (the reference's tests/test_pipeline.py shapes)
PP_D, PP_STAGES, PP_M, PP_MB = 8, 4, 6, 2


def pp_inputs(stages: int = PP_STAGES, rows: int = 1) -> dict:
    """Per-stage ``w{i}``, ``b{i}``; microbatches ``x`` and cotangents
    ``g`` for each of ``rows`` pipelines."""
    rng = np.random.default_rng(51 + stages + rows)
    out = {}
    for i in range(stages):
        out[f"w{i}"] = rng.normal(size=(PP_D, PP_D)).astype(np.float32) * 0.5
        out[f"b{i}"] = rng.normal(size=(PP_D,)).astype(np.float32) * 0.1
    for n in ("x", "g"):
        out[n] = rng.normal(size=(rows, PP_M, PP_MB, PP_D)).astype(
            np.float32)
    return out


def pp_stage_fn(p, x):
    """The pipeline tests' stage, ``tanh(x·w + b)`` (numpy or torch)."""
    mod = np if isinstance(x, np.ndarray) else __import__("torch")
    return mod.tanh(x @ p["w"] + p["b"])


def _run_pipeline(inp: dict, stage: int, row: int) -> dict:
    """This rank's stage over the pipeline axis: the outputs, and the
    gradients of ``sum(out · g)`` of its stage parameters and of x."""
    import torch

    from horovod_tpu_torch.parallel.pipeline import pipeline_apply

    p = {n: torch.from_numpy(inp[f"{n}{stage}"]).requires_grad_()
         for n in ("w", "b")}
    x = torch.from_numpy(inp["x"][row]).requires_grad_()
    out = pipeline_apply(pp_stage_fn, p, x, axis="pp")
    (out * torch.from_numpy(inp["g"][row])).sum().backward()
    return {"out": out.detach().numpy(), "dw": p["w"].grad.numpy(),
            "db": p["b"].grad.numpy(), "dx": x.grad.numpy()}


def _task_pp(workdir: Path):
    """A 4-stage pipeline over the world, then (dp, pp) = (2, 2)."""
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.parallel.mesh import make_mesh, use_mesh

    htt.init(device="cpu")
    out = {}
    mesh = make_mesh((PP_STAGES,), ("pp",))
    with use_mesh(mesh):
        got = _run_pipeline(pp_inputs(), mesh.get_local_rank("pp"), 0)
    out.update({f"pp/{k}": v for k, v in got.items()})
    mesh = make_mesh((2, 2), ("dp", "pp"))
    with use_mesh(mesh):
        got = _run_pipeline(pp_inputs(2, 2), mesh.get_local_rank("pp"),
                            mesh.get_local_rank("dp"))
    out.update({f"dp_pp/{k}": v for k, v in got.items()})
    htt.shutdown()
    return out


#: the moe task's layer (the reference's tests/test_moe.py shapes): width,
#: experts a rank, tokens a rank, and the capacities run
MOE_D, MOE_PER_RANK, MOE_N_LOCAL, MOE_CAPACITIES = 8, 2, 16, (4, 16)


def moe_inputs(ep: int) -> dict:
    """The experts ``w [E, d, 16]``, ``v [E, 16, d]``, the router ``[d,
    E]``, every rank's tokens ``x`` and cotangents ``g``."""
    rng = np.random.default_rng(61)
    e = ep * MOE_PER_RANK
    return {
        "w": rng.normal(size=(e, MOE_D, 16)).astype(np.float32) * 0.5,
        "v": rng.normal(size=(e, 16, MOE_D)).astype(np.float32) * 0.5,
        "router": rng.normal(size=(MOE_D, e)).astype(np.float32),
        "x": rng.normal(size=(ep, MOE_N_LOCAL, MOE_D)).astype(np.float32),
        "g": rng.normal(size=(ep, MOE_N_LOCAL, MOE_D)).astype(np.float32),
    }


def moe_expert_fn(p, x):
    """The MoE tests' expert, ``tanh(x·w)·v`` (numpy or torch)."""
    mod = np if isinstance(x, np.ndarray) else __import__("torch")
    return mod.tanh(x @ p["w"]) @ p["v"]


def _task_moe(workdir: Path):
    """moe_apply over the world at each capacity: this rank's output and
    the gradients of ``sum(out · g)`` this rank computes (its experts',
    the router's, its tokens')."""
    import torch

    import horovod_tpu_torch as htt
    from horovod_tpu_torch.convert import moe_params_from_flax
    from horovod_tpu_torch.parallel.moe import moe_apply

    htt.init(device="cpu")
    r, n = htt.rank(), htt.size()
    inp = moe_inputs(n)
    out = {}
    for cap in MOE_CAPACITIES:
        p = moe_params_from_flax({"experts": {"w": inp["w"], "v": inp["v"]},
                                  "router": inp["router"]}, rank=r, ep=n)
        experts = {k: t.requires_grad_() for k, t in p["experts"].items()}
        router = p["router"].requires_grad_()
        x = torch.from_numpy(inp["x"][r]).requires_grad_()
        y = moe_apply(moe_expert_fn, experts, x, router, capacity=cap,
                      axis=None)
        (y * torch.from_numpy(inp["g"][r])).sum().backward()
        out.update({f"{cap}/out": y.detach().numpy(),
                    f"{cap}/dw": experts["w"].grad.numpy(),
                    f"{cap}/dv": experts["v"].grad.numpy(),
                    f"{cap}/drouter": router.grad.numpy(),
                    f"{cap}/dx": x.grad.numpy()})
    out["indivisible_error"] = np.asarray(_raises(
        lambda: moe_apply(moe_expert_fn, experts, x, router[:, :3],
                          capacity=4, axis=None), ValueError,
        "not divisible"))
    htt.shutdown()
    return out


def _task_drives(workdir: Path):
    """The reference's dp×sp, dp×tp, dp×pp and ep drives (dp×tp from the
    reference's weights in inputs.npz); with 8 ranks, dp×tp×pp alone."""
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.examples import multichip_drives as drives

    htt.init(device="cpu")
    if htt.size() == 8:
        out = {"dp_tp_pp": np.asarray(drives.dp_tp_pp())}
    else:
        inputs = dict(np.load(workdir / "inputs.npz"))
        out = {"dp_sp": np.asarray(drives.dp_sp()),
               "dp_tp": np.asarray(drives.dp_tp(inputs)),
               "dp_pp": np.asarray(drives.dp_pp()),
               "ep": np.asarray(drives.ep())}
    htt.shutdown()
    return out


#: the sp bench tasks' runs: (bench, --seq-parallel, --attn); the benches
#: at tiny size, 2 steps, float32
SP_BENCH_RUNS = (("gpt", "ring", "torch"), ("gpt", "ulysses", "torch"),
                 ("gpt", "ring", "flash"), ("bert", "ring", "xla"),
                 ("bert", "ulysses", "xla"), ("bert", "ring", "pallas"))
SP_BENCH_ARGV = ["--model", "tiny", "--batch-size", "2", "--seq-len", "32",
                 "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
                 "--num-iters", "1", "--dtype", "float32", "--device", "cpu"]


def _task_sp_bench(workdir: Path, bench: str):
    """``bench``'s SP_BENCH_RUNS through its ``run``, the model (and
    BERT's head) loaded from the reference's initial values in
    inputs.npz (``<bench>:<path>``, ``head``): the final losses."""
    import torch

    from horovod_tpu_torch import core
    from horovod_tpu_torch.convert import load_flax_variables
    from horovod_tpu_torch.examples import bert_synthetic_benchmark as bb
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    inputs = dict(np.load(workdir / "inputs.npz"))
    mod = gb if bench == "gpt" else bb
    factory = "gpt_tiny" if bench == "gpt" else "bert_tiny"
    tiny = getattr(mod, factory)

    def build(**kw):
        model = tiny(**kw)
        load_flax_variables(model, nested_flax(inputs, f"{bench}:"))
        return model

    setattr(mod, factory, build)
    if bench == "bert":
        bb.mlm_head = lambda hidden, vocab, device: torch.from_numpy(
            inputs["head"]).to(device)
    out = {}
    for b, sp, attn in SP_BENCH_RUNS:   # one world: init is idempotent
        if b == bench:
            res = mod.run(mod.parse_args(SP_BENCH_ARGV + [
                "--seq-parallel", sp, "--attn", attn]))
            out[f"{bench}/{sp}/{attn}"] = np.asarray(res["final_loss"])
    core.shutdown()
    return out


def nested_flax(flat: dict, prefix: str = "") -> dict:
    """The ``prefix``-keyed entries of ``flat`` (``"a/b"`` paths) as a
    nested flax dict."""
    nested: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = nested
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return nested


def snapshot_samples(registry, skip=()) -> dict:
    """``{family: [(labels, value or count)]}`` of a metrics registry's
    families with samples, but those in ``skip``: names, labels, values
    — a histogram by its count only (its sum and bucket placement are
    timings)."""
    import json

    out = {}
    for name, fam in registry.snapshot()["metrics"].items():
        if not fam["samples"] or name in skip:
            continue
        key = "count" if fam["type"] == "histogram" else "value"
        out[name] = sorted((json.dumps(s["labels"], sort_keys=True), s[key])
                           for s in fam["samples"])
    return out


def eager_drive(eager, frontend, rank: int) -> None:
    """The eager drive of the trace tests, the same calls on either
    package (the reference's eager plane and torch frontend take these
    numpy arrays and torch tensors as the port's do)."""
    import torch

    a = np.arange(6, dtype=np.float32).reshape(2, 3) + rank
    eager.process_allreduce(a, name="grad.a")
    eager.process_allreduce(a.astype(np.float64), op="Sum", name="grad.b")
    eager.process_allgather(a[:1 + rank], name="rows")
    frontend.allreduce(torch.from_numpy(a), name="allreduce.w")
    frontend.allreduce(torch.from_numpy(a), name="allreduce.w", op="Max")
    frontend.join()


def _task_trace(workdir: Path):
    """:func:`eager_drive` with the timeline on (``<workdir>/trace``):
    this rank's metrics (:func:`snapshot_samples`, as JSON); its
    ``comm.json`` and ``metrics.json`` are left in the trace dir."""
    import json

    os.environ["HVD_TIMELINE"] = str(workdir / "trace")
    import horovod_tpu_torch as htt
    import horovod_tpu_torch.torch as frontend
    from horovod_tpu_torch import eager, metrics

    htt.init(device="cpu")
    metrics.registry.reset()
    eager_drive(eager, frontend, htt.rank())
    out = {"metrics": json.dumps(snapshot_samples(metrics.registry))}
    htt.shutdown()
    return out


def _task_replay(workdir: Path):
    """The trace the replay tests read: :func:`eager_drive` with the
    timeline on (``<workdir>/trace``, closed before returning), then the
    projection's live trace of this world (``<workdir>/live``)."""
    os.environ["HVD_TIMELINE"] = str(workdir / "trace")
    import horovod_tpu_torch as htt
    import horovod_tpu_torch.torch as frontend
    from horovod_tpu_torch import eager
    from horovod_tpu_torch.timeline.replay.projection import live_trace
    from horovod_tpu_torch.timeline.timeline import timeline

    htt.init(device="cpu")
    eager_drive(eager, frontend, htt.rank())
    timeline.shutdown()
    live_trace(str(workdir / "live"), steps=3, global_batch=16, in_dim=8,
               classes=4, width=16)
    htt.shutdown()
    return {}


#: GP sample settings of the autotune task: one warm-up sample, then a
#: new knob vector every AUTOTUNE_SPS steps
AUTOTUNE_SPS = 2
AUTOTUNE_STEPS = 12


def _task_autotune(workdir: Path):
    """The MLP trained AUTOTUNE_STEPS steps with ``autotune=True`` and
    again untuned: both runs' losses, and the tuned run's knob sets
    (threshold and hierarchical flag of each build)."""
    os.environ.update({"HVD_AUTOTUNE_WARMUP_SAMPLES": "1",
                       "HVD_AUTOTUNE_STEPS_PER_SAMPLE": str(AUTOTUNE_SPS)})
    import horovod_tpu_torch as htt

    inputs = dict(np.load(workdir / "inputs.npz"))
    htt.init(device="cpu")
    keep: dict = {}
    tuned = _train_mlp(htt, inputs, AUTOTUNE_STEPS, keep=keep,
                       autotune=True)
    plain = _train_mlp(htt, inputs, AUTOTUNE_STEPS)
    builds = keep["step"].builds
    htt.shutdown()
    return {"tuned": tuned["losses"], "plain": plain["losses"],
            "thresholds": np.asarray([b["threshold"] for b in builds]),
            "hierarchical": np.asarray([b["hierarchical"]
                                        for b in builds])}


def _task_fail(workdir: Path):
    """Rank 1 fails before it joins; rank 0 waits for it in init."""
    import horovod_tpu_torch as htt

    if os.environ["HVD_PROCESS_ID"] == "1":
        raise RuntimeError("planted failure of rank 1")
    htt.init(device="cpu")
    return {}


TASKS = {"core": _task_core, "fail": _task_fail, "fusion": _task_fusion,
         "train_mlp": _task_train_mlp, "collectives": _task_collectives,
         "wire": _task_wire, "train_wire": _task_train_wire,
         "ring": _task_ring, "tp": _task_tp, "pp": _task_pp,
         "moe": _task_moe, "drives": _task_drives, "trace": _task_trace,
         "replay": _task_replay, "autotune": _task_autotune,
         "sp_bench_gpt": lambda w: _task_sp_bench(w, "gpt"),
         "sp_bench_bert": lambda w: _task_sp_bench(w, "bert")}


def main():
    task, workdir = sys.argv[1], Path(sys.argv[2])
    store = _rendezvous(workdir, task)
    out = TASKS[task](workdir)
    del store
    rank = os.environ["HVD_PROCESS_ID"]
    np.savez(workdir / f"{task}.{rank}.npz", **out)


if __name__ == "__main__":
    main()
