"""The port's serving plane (``horovod_tpu_torch/serving/``) held to the
reference's (``horovod_tpu/serving/``) on the CPU.

* Exact: the broker's counts and pull order over one scripted call
  sequence, ``percentile``, the batcher's flushes on a scripted clock,
  the bucket ladder and its padding, seeded arrivals, ``summarize``, and
  the autoscale policy's decisions over a seeded tick sequence.
* ``compress_params`` int8 and fp8: q and the factor bit-equal to the
  reference's ``numpy_quantize``; ``bf16`` raises a ``ValueError`` naming
  the supported wires where the reference raises a bare ``KeyError``.
* The replica serving the reference's MLP (flax weights converted) and
  ``ConvNet`` within the reference's float32 limits of ``model.apply``
  (``np.allclose``, atol 1e-5), from a checkpoint, and with int8 at rest
  against the reference's own int8 replica.
* A poison batch, the drain and the requeue; the driver's drained and
  lossy removals; ``post_infer`` and ``serve_pull`` across the packages;
  the serve CLI's ``--check`` in process.  Clocks and ticks are driven
  directly; the only waits are for a replica thread's answer.
"""

import json
import threading

import numpy as np
import pytest
import torch

from horovod_tpu.models.mlp import MLP as RefMLP
from horovod_tpu.models.mlp import ConvNet as RefConvNet
from horovod_tpu.run import http_client as ref_client
from horovod_tpu.run.http_server import RendezvousServer as RefServer
from horovod_tpu.serving import autoscaler as ref_autoscaler
from horovod_tpu.serving import batching as ref_batching
from horovod_tpu.serving import broker as ref_broker
from horovod_tpu.serving import frontend as ref_frontend
from horovod_tpu.serving import loadgen as ref_loadgen
from horovod_tpu.serving import replica as ref_replica
from horovod_tpu_torch import convert
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.models.mlp import MLP, ConvNet
from horovod_tpu_torch.run import http_client
from horovod_tpu_torch.run.http_server import (
    DRAIN_ACK_PREFIX,
    DRAIN_PREFIX,
    MEMBERSHIP_SCOPE,
    RendezvousServer,
)
from horovod_tpu_torch.serving import (
    AutoscalePolicy,
    BatchBucketer,
    ContinuousBatcher,
    InferenceReplica,
    RemoteSource,
    RequestBroker,
    ServingFrontend,
    autoscaler,
    batching,
    broker,
    compress_params,
    decompress_params,
    load_params,
    loadgen,
    module_apply_fn,
    replica,
)
from horovod_tpu_torch.serving.__main__ import main as serve_main
from horovod_tpu_torch.utils.checkpoint import save_checkpoint


def _double(params, x):
    return x * 2.0


def _replica(source, apply_fn=_double, params=None, **kw):
    kw.setdefault("replica_id", "0")
    kw.setdefault("jit", False)
    return InferenceReplica(source, apply_fn, params, device="cpu", **kw)


# -- the broker, exact -------------------------------------------------------
def _broker_script(mod):
    """One call sequence through a broker module: every count and every
    pulled id along the way."""
    b = mod.RequestBroker(queue_limit=4)
    trace = []
    reqs = [b.submit(np.full(1, float(i))) for i in range(4)]
    try:
        b.submit(np.zeros(1))
    except mod.QueueFullError:
        trace.append("rejected")
    trace.append([r.id for r in b.pull("a", 2, 0.0)])
    trace.append(b.complete(reqs[0], np.ones(1), "a"))
    trace.append(b.complete(reqs[0], np.ones(1), "b"))    # duplicate
    trace.append(b.fail(reqs[1], "poison", "a"))
    trace.append([r.id for r in b.pull("b", 1, 0.0)])
    trace.append(b.requeue("b"))
    b.drain_begin("c")
    trace.append(b.pull("c", 4, 0.0))
    b.drain_end("c")
    trace.append([r.id for r in b.pull("c", 4, 0.0)])
    trace.append(b.wait_drained("c", 0.0))
    for r in reqs[2:]:
        trace.append(b.complete(r, r.inputs, "c"))
    late = b.submit(np.zeros(1))
    try:
        b.wait(late, timeout=0.0)
    except TimeoutError:
        trace.append("abandoned")
    trace.append(b.complete(late, np.zeros(1), "c"))
    stats = b.window_stats()
    for k in ("p50_ms", "p99_ms", "mean_ms"):
        stats[k] = stats[k] is not None
    return trace, stats


def test_broker_counts_and_order_match_reference():
    assert _broker_script(broker) == _broker_script(ref_broker)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentile_matches_reference(seed):
    rng = np.random.RandomState(seed)
    vals = list(rng.exponential(10.0, size=rng.randint(1, 300)))
    for q in (1.0, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert broker.percentile(vals, q) == ref_broker.percentile(vals, q)
    assert broker.percentile([], 50.0) is None


# -- batching, exact ---------------------------------------------------------
def _batcher_script(mod, seed):
    """Flushes on a scripted clock: each pull costs seeded time and
    returns a seeded number of requests."""
    rng = np.random.RandomState(seed)
    clock = [0.0]
    nxt = [0]

    def pull(n, wait_s):
        clock[0] += float(rng.uniform(0.0, 0.004))
        k = min(int(rng.randint(0, 3)), n)
        out = list(range(nxt[0], nxt[0] + k))
        nxt[0] += k
        return out

    b = mod.ContinuousBatcher(pull, max_batch=8, max_wait_ms=5.0,
                              clock=lambda: clock[0])
    return [b.next_batch() for _ in range(40)], b.batches


@pytest.mark.parametrize("seed", [0, 1])
def test_batcher_flushes_match_reference(seed):
    assert _batcher_script(batching, seed) == \
        _batcher_script(ref_batching, seed)


def test_bucket_ladder_and_padding_match_reference(monkeypatch):
    for top in (1, 5, 8, 32):
        assert batching.bucket_sizes_from_env(top) == \
            ref_batching.bucket_sizes_from_env(top)
    monkeypatch.setenv("HVD_SERVE_BUCKET_SIZES", "4,1,16,4")
    assert batching.bucket_sizes_from_env(8) == \
        ref_batching.bucket_sizes_from_env(8) == (1, 4, 16)
    ours, theirs = BatchBucketer((1, 2, 4, 8)), \
        ref_batching.BatchBucketer((1, 2, 4, 8))
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    for n in range(1, 9):
        assert ours.bucket(n) == theirs.bucket(n)
    (a, na), (b, nb) = ours.pad(x), theirs.pad(x)
    assert na == nb and np.array_equal(a, b)
    with pytest.raises(ValueError):
        ours.bucket(9)


# -- load generation, exact --------------------------------------------------
@pytest.mark.parametrize("seed", [7, 11])
def test_arrivals_and_summary_match_reference(seed):
    assert loadgen.poisson_arrivals(120.0, 1.5, seed) == \
        ref_loadgen.poisson_arrivals(120.0, 1.5, seed)
    kw = dict(pre_s=0.5, burst_s=0.5, post_s=0.3, seed=seed)
    ours = loadgen.bursty_arrivals(40.0, 200.0, **kw)
    assert ours == ref_loadgen.bursty_arrivals(40.0, 200.0, **kw)
    rng = np.random.RandomState(seed)
    records = [{"t": t, "latency_ms": float(rng.exponential(40.0)),
                "ok": bool(rng.rand() > 0.05)} for t in ours[0]]
    assert loadgen.summarize(records, 100.0, ours[1]) == \
        ref_loadgen.summarize(records, 100.0, ours[1])


def test_open_loop_generator_admits_on_schedule_and_times_from_it():
    """Every arrival is admitted while no answer has come (a stalled
    server delays no arrival), a refusal and a failed request are
    recorded outcomes, and a latency runs from the scheduled arrival to
    the request's completion."""
    b = RequestBroker(queue_limit=40)
    arrivals = [i * 1e-4 for i in range(50)]
    reqs, answered = [], threading.Event()

    def submit(x):
        r = b.submit(x)
        reqs.append(r)
        return r

    def server():  # answers only once the whole trace is offered
        while b.submitted + b.rejected < len(arrivals):
            threading.Event().wait(0.001)
        batch = b.pull("0", len(arrivals), 0.0)
        b.fail(batch[0], "poison", "0")
        for r in batch[1:]:
            b.complete(r, r.inputs * 2.0, "0")
        answered.set()

    t = threading.Thread(target=server)
    t.start()
    gen = loadgen.OpenLoopLoadGenerator(
        submit, arrivals, lambda i: np.full(2, float(i)), wait=b.wait,
        slo_ms=1e6, timeout_s=30.0)
    summary = gen.run()
    t.join()
    assert answered.is_set()
    assert (summary["offered"], summary["completed"]) == (50, 39)
    assert [r["rejected"] for r in gen.records] == \
        [True] + [False] * 39 + [True] * 10
    admitted = [r for r in gen.records if "QueueFull" not in
                r.get("error", "")]
    assert len(admitted) == len(reqs) == 40
    for rec, req in zip(admitted[1:], reqs[1:]):
        assert rec["ok"] and rec["late_ms"] >= 0.0
        # from the schedule, which is no later than the submit
        assert rec["latency_ms"] >= \
            (req.complete_time - req.submit_time) * 1000.0


class _Driver:
    """The driver surface the autoscaler reads: a world, spares, epochs."""

    def __init__(self):
        self.world, self.spares, self.epoch = ["0"], ["1"], 0
        self.initial, self.finished, self.failed_reason = ["0"], set(), None

    def admit_spare(self, reason=""):
        self.world.append(self.spares.pop(0))
        self.epoch += 1
        return self.world[-1]

    def remove(self, worker, reason, drain=False):
        self.world.remove(worker)
        self.epoch += 1
        return True


def test_autoscaler_events_match_reference_and_carry_times():
    def run(mod, broker_mod):
        b = broker_mod.RequestBroker()
        clock = [0.0]
        a = mod.ServingAutoscaler(
            _Driver(), b, mod.AutoscalePolicy(
                queue_high=4, queue_low=0.5, slo_ms=1e6,
                hysteresis_ticks=1, cooldown_s=1.0, min_replicas=1,
                max_replicas=2, clock=lambda: clock[0]),
            headroom_fn=lambda *a: None)
        reqs = [b.submit(np.zeros(1)) for _ in range(8)]
        decisions = [a.tick()]
        for r in b.pull("0", 8, 0.0):
            b.complete(r, r.inputs, "0")
        for _ in range(3):
            clock[0] += 0.6
            decisions.append(a.tick())
        return decisions, a.events, len(reqs)

    ours, ref = run(autoscaler, broker), run(ref_autoscaler, ref_broker)
    assert ours[:2] == ref[:2]
    assert ours[1] == [("grow", "1", 1), ("shrink", "1", 2)]
    a = autoscaler.ServingAutoscaler(_Driver(), RequestBroker(),
                                     headroom_fn=lambda *a: None)
    a._record_event("grow", "1")
    a._record_event("shrink", "1")
    assert len(a.event_times) == 2 and \
        a.event_times[0] <= a.event_times[1]


# -- the autoscale policy, exact ---------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_decisions_match_reference(seed):
    rng = np.random.RandomState(seed)
    ticks = [(int(rng.choice([0, 0, 0, 1, 3, 8, 16])),
              None if rng.rand() < 0.2 else float(rng.uniform(5, 150)),
              int(rng.randint(1, 5)), int(rng.randint(0, 3)),
              float(rng.uniform(0.0, 4.0))) for _ in range(200)]

    def run(mod):
        clock = [0.0]
        p = mod.AutoscalePolicy(queue_high=4, queue_low=0.5, slo_ms=100,
                                hysteresis_ticks=3, cooldown_s=6,
                                min_replicas=1, max_replicas=3,
                                clock=lambda: clock[0])
        out = []
        for depth, p99, reps, spares, dt in ticks:
            out.append(p.decide(queue_depth=depth, p99_ms=p99,
                                replicas=reps, spares=spares))
            clock[0] += dt
        return out

    got = run(autoscaler)
    assert got == run(ref_autoscaler)
    assert {"grow", "shrink", "hold"} <= set(got)


# -- weights at rest ---------------------------------------------------------
@pytest.mark.parametrize("wire", ["int8", "fp8", "fp8_e4m3", "fp8_e5m2"])
def test_compress_params_bit_equal_to_reference(wire):
    rng = np.random.RandomState(3)
    tree = {"Dense_0": {"kernel": rng.randn(16, 8).astype(np.float32),
                        "bias": (rng.randn(8) * 1e-3).astype(np.float32)},
            "count": np.arange(5, dtype=np.int32)}
    theirs, ref_info = ref_replica.compress_params(tree, wire)
    ours, info = compress_params(
        {"Dense_0": {k: torch.from_numpy(v)
                     for k, v in tree["Dense_0"].items()},
         "count": torch.from_numpy(tree["count"])}, wire)
    assert info == ref_info
    for k in ("kernel", "bias"):
        (q, f), (rq, rf) = ours["Dense_0"][k], theirs["Dense_0"][k]
        assert f == rf
        assert q.view(torch.uint8).numpy().tobytes() == \
            np.asarray(rq).view(np.uint8).tobytes()
    assert np.array_equal(ours["count"].numpy(), theirs["count"])
    back, ref_back = decompress_params(ours), \
        ref_replica.decompress_params(theirs)
    for k in ("kernel", "bias"):
        assert np.array_equal(back["Dense_0"][k].numpy(),
                              np.asarray(ref_back["Dense_0"][k]))


def test_bf16_at_rest_is_a_value_error_not_a_key_error(monkeypatch):
    """The reference documents ``HVD_SERVE_WEIGHT_COMPRESSION`` as
    none|bf16|int8|fp8, but its quantizer knows no bf16 wire and raises a
    bare ``KeyError``; the port names the wires it supports."""
    tree = {"w": np.ones((2, 2), np.float32)}
    with pytest.raises(KeyError, match="bf16"):
        ref_replica.compress_params(tree, "bf16")
    with pytest.raises(ValueError, match="int8, fp8, fp8_e4m3, fp8_e5m2"):
        compress_params({"w": torch.ones(2, 2)}, "bf16")
    monkeypatch.setenv("HVD_SERVE_WEIGHT_COMPRESSION", "bf16")
    with pytest.raises(ValueError, match="supported wires"):
        _replica(RequestBroker(), params={"w": torch.ones(2)})


# -- the replica against the reference's forward -----------------------------
def _flax_variables(shapes, seed):
    """Seeded numpy weights in the reference's flax layout
    (``{"params": {"Dense_0": {"kernel", "bias"}, ...}}``)."""
    rng = np.random.RandomState(seed)
    return {"params": {name: {
        "kernel": (rng.randn(*k) / np.sqrt(np.prod(k[:-1]))).astype(
            np.float32),
        "bias": (0.1 * rng.randn(k[-1])).astype(np.float32)}
        for name, k in shapes.items()}}


def _flax_mlp(in_dim, seed):
    model = RefMLP(features=(64, 32, 10))
    variables = _flax_variables({"Dense_0": (in_dim, 64),
                                 "Dense_1": (64, 32),
                                 "Dense_2": (32, 10)}, seed)
    port = MLP(in_dim, (64, 32, 10))
    convert.load_flax_variables(port, variables["params"])
    return model, variables, port.eval()


def _serve(rep, broker_, xs):
    rep.start()
    try:
        return np.stack([broker_.submit_and_wait(x, timeout=30.0)
                         for x in xs])
    finally:
        rep.stop()


def test_replica_serves_mlp_from_checkpoint_like_reference(tmp_path):
    model, variables, port = _flax_mlp(16, seed=3)
    apply_fn, params = module_apply_fn(port)
    save_checkpoint(str(tmp_path), params, step=5)
    like = {k: torch.zeros_like(v) for k, v in params.items()}
    restored = load_params(str(tmp_path), like)
    b = RequestBroker()
    rep = _replica(b, apply_fn, restored, jit=True, max_batch=4,
                   bucket_sizes=(1, 2, 4))
    xs = np.random.RandomState(0).randn(6, 16).astype(np.float32)
    got = _serve(rep, b, xs)
    want = np.asarray(model.apply(variables, xs))
    assert np.allclose(got, want, atol=1e-5)
    assert rep.recompiles <= 3


def test_int8_replica_matches_the_reference_int8_replica():
    model, variables, port = _flax_mlp(16, seed=1)
    apply_fn, params = module_apply_fn(port)
    xs = np.random.RandomState(1).randn(3, 16).astype(np.float32)
    b, rb = RequestBroker(), ref_broker.RequestBroker()
    rep = _replica(b, apply_fn, params, weight_compression="int8",
                   max_batch=1)
    ref = ref_replica.InferenceReplica(
        rb, model.apply, variables, replica_id="0",
        weight_compression="int8", jit=False, max_batch=1)
    assert rep.compression_info["ratio"] > 3.5
    assert rep.compression_info["orig_bytes"] == \
        ref.compression_info["orig_bytes"]
    assert np.allclose(_serve(rep, b, xs), _serve(ref, rb, xs), atol=1e-5)


def test_replica_serves_convnet_like_reference():
    xs = np.random.RandomState(2).randn(3, 6, 6, 1).astype(np.float32)
    model = RefConvNet()
    variables = _flax_variables({"Conv_0": (3, 3, 1, 32),
                                 "Conv_1": (3, 3, 32, 64),
                                 "Dense_0": (64, 128),
                                 "Dense_1": (128, 10)}, seed=2)
    port = ConvNet(image_size=6)
    convert.load_flax_variables(port, variables["params"])
    apply_fn, params = module_apply_fn(port.eval())
    b = RequestBroker()
    rep = _replica(b, apply_fn, params, jit=True, max_batch=2)
    assert np.allclose(_serve(rep, b, xs),
                       np.asarray(model.apply(variables, xs)), atol=1e-5)


def test_poison_batch_fails_its_requests_not_the_replica():
    def sometimes(params, x):
        if float(x[0, 0]) < 0:
            raise ValueError("negative marker")
        return x

    b = RequestBroker()
    rep = _replica(b, sometimes, max_batch=1).start()
    try:
        with pytest.raises(RuntimeError, match="negative marker"):
            b.submit_and_wait(np.full((2,), -1.0), timeout=10.0)
        assert np.allclose(b.submit_and_wait(np.full((2,), 3.0),
                                             timeout=10.0), 3.0)
        assert b.failed == 1 and rep.running
    finally:
        rep.stop()


def test_drain_finishes_in_flight_and_requeue_keeps_order():
    b = RequestBroker()
    reqs = [b.submit(np.full(2, float(i))) for i in range(5)]
    stranded = b.pull("dead", 3, 0.0)
    assert b.requeue("dead") == 3 and [r.id for r in stranded] == [0, 1, 2]
    rep = _replica(b, max_batch=4, bucket_sizes=(1, 2, 4)).start()
    outs = [b.wait(r, 10.0) for r in reqs]
    assert rep.drain_window is None and rep.drain(timeout=10.0)
    assert rep.drain_window[0] <= rep.drain_window[1]
    assert not rep.running and b.pull("0", 1, 0.0) == []
    assert [float(o[0]) for o in outs] == [0.0, 2.0, 4.0, 6.0, 8.0]
    assert (b.completed, b.duplicates, b.requeued) == (5, 0, 3)


# -- the driver's removals ---------------------------------------------------
def test_driver_drained_and_lossy_removals():
    server = RendezvousServer(secret=None)
    server.start()
    try:
        b = RequestBroker()
        drv = ElasticDriver(server, ["0", "1", "2"], min_np=1,
                            drain_timeout=10.0)
        drv.on_remove = lambda w, drained: None if drained \
            else b.requeue(w)
        b.submit(np.zeros(1))
        b.pull("1", 1, 0.0)
        assert drv.remove("1", "worker 1 exited with code 9")  # lossy
        assert b.requeued == 1 and drv.flaps["1"] == 1

        def ack():  # the worker side of the drain handshake
            while server.get(MEMBERSHIP_SCOPE, f"{DRAIN_PREFIX}2") is None:
                threading.Event().wait(0.005)
            server.put(MEMBERSHIP_SCOPE, f"{DRAIN_ACK_PREFIX}2",
                       json.dumps({"worker": "2"}).encode())

        t = threading.Thread(target=ack)
        t.start()
        assert drv.remove("2", "scale down", drain=True)
        t.join()
        rec = json.loads(server.get(MEMBERSHIP_SCOPE, "epoch"))
        assert rec["world"] == ["0"] and "drained" in rec["reason"]
        assert b.requeued == 1 and drv.flaps.get("2", 0) == 0
        drv.shutdown()
    finally:
        server.stop()


# -- the request plane across the packages -----------------------------------
def test_reference_client_against_port_server_and_frontend():
    secret = b"infer-secret"
    server = RendezvousServer(secret=secret)
    port = server.start()
    b = RequestBroker()
    server.attach_serving(ServingFrontend(b, timeout_s=20.0))
    rep = _replica(b, max_batch=4, max_wait_ms=2.0).start()
    try:
        out = ref_client.post_infer("127.0.0.1", port, [1.0, 2.0],
                                    secret=secret)
        assert out["outputs"] == [2.0, 4.0] and out["replica"] == "0"
        page = ref_client.get_serving("127.0.0.1", port, secret=secret)
        assert page["broker"]["completed"] == 1
        assert page == {**http_client.get_serving(
            "127.0.0.1", port, secret=secret), "broker": page["broker"]}
        # a full queue is the reference's 503
        server.attach_serving(ServingFrontend(RequestBroker(queue_limit=0)))
        with pytest.raises(RuntimeError, match="503"):
            http_client.post_infer("127.0.0.1", port, [1.0], secret=secret)
    finally:
        rep.stop()
        server.stop()


def test_port_remote_source_against_reference_server():
    secret = b"remote-secret"
    server = RefServer(secret=secret)
    port = server.start()
    b = ref_broker.RequestBroker()
    server.attach_serving(ref_frontend.ServingFrontend(b))
    rep = _replica(RemoteSource("127.0.0.1", port, secret=secret),
                   replica_id="w7", max_batch=4, max_wait_ms=2.0).start()
    try:
        out = b.submit_and_wait(np.full((3,), 5.0, np.float32), timeout=20.0)
        assert np.array_equal(out, np.full((3,), 10.0, np.float32))
        assert b.window_stats()["completed"] == 1
        got = ref_client.serve_pull("127.0.0.1", port, "w8", 2,
                                    secret=secret)
        assert got == http_client.serve_pull("127.0.0.1", port, "w8", 2,
                                              secret=secret) \
            == {"requests": []}
    finally:
        rep.stop()
        server.stop()


# -- the CLI and the entry points' device ------------------------------------
def test_serve_cli_check_in_process(capsys):
    assert serve_main(["--check"]) == 0
    assert "zero drops/duplicates" in capsys.readouterr().out


def test_replica_without_cuda_and_without_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceReplica(RequestBroker(), _double, None, replica_id="0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replica.resolve_device()
