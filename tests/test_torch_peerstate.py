"""horovod_tpu_torch.elastic.peerstate against horovod_tpu.elastic.peerstate.

* ``choose_peers``, ``shard_payload`` and ``checksum`` give the
  reference's answers on a table of inputs;
* the same snapshot (a float32 state of numpy leaves, the same workers,
  clock and placement) writes byte-equal manifests and commit markers
  into the KV store from either package;
* a float32 snapshot restores across packages both ways, through one
  ``RendezvousServer`` whose peers are managers of both packages: the
  reference's restored into the port's tensors, the port's (tensors sent
  as numpy) read by the reference;
* the port's trouble spot: its tensors are updated in place, so
  ``snapshot()`` copies them into its buffer at enqueue time — a tensor
  mutated after ``snapshot()`` restores its enqueue-time values, also
  across a latest-wins replacement, and a bfloat16 leaf comes back bit
  for bit;
* ``ElasticState`` over a peer fixture on the CPU: every save a peer
  snapshot, storage demoted, ``resume()`` from the peers first.
"""

import json

import numpy as np
import pytest
import torch

from horovod_tpu.elastic import peerstate as ref_ps
from horovod_tpu.run import http_server as ref_srv
from horovod_tpu_torch.elastic import faults, membership, peerstate
from horovod_tpu_torch.run import http_server
from horovod_tpu_torch.run.http_server import RendezvousServer

SECRET = b"port-peerstate"


@pytest.fixture()
def rdv(monkeypatch):
    server = RendezvousServer(secret=SECRET)
    server.start()
    monkeypatch.setenv("HVD_METRICS_KV_ADDR", "127.0.0.1")
    monkeypatch.setenv("HVD_METRICS_KV_PORT", str(server.port))
    monkeypatch.setenv("HVD_METRICS_SECRET", SECRET.hex())
    monkeypatch.setenv("HVD_RING_HOST", "127.0.0.1")
    monkeypatch.setenv("HVD_NUM_PROCESSES", "1")
    monkeypatch.delenv("HVD_FAULT_SPEC", raising=False)
    faults.reset()
    membership._reset_for_tests()
    made = []
    yield server, made
    for m in made:
        m.stop()
    peerstate.reset()
    membership._reset_for_tests()
    server.stop()


def _manager(mod, server, made, worker, rank, **kw):
    kw.setdefault("replicas_k", 2)
    kw.setdefault("nshards", 3)
    m = mod.PeerSnapshotManager(addr="127.0.0.1", port=server.port,
                                secret=SECRET, worker=worker, rank=rank,
                                **kw)
    m._host_label = lambda: "host-a"  # noqa: E731 — one placement label
    m.start()
    made.append(m)
    return m


@pytest.mark.parametrize("payload,n", [(b"", 4), (b"abc", 8),
                                       (bytes(range(256)) * 7, 4),
                                       (b"x" * 10, 3), (b"y" * 9, 1)])
def test_shard_payload_and_checksum_match_reference(payload, n):
    assert peerstate.shard_payload(payload, n) == \
        ref_ps.shard_payload(payload, n)
    assert peerstate.checksum(payload) == ref_ps.checksum(payload)


@pytest.mark.parametrize("me,k,local", [("0", 2, 1), ("3", 1, 1),
                                        ("1", 3, 1), ("2", 2, 8),
                                        ("9", 2, 1), ("0", 0, 1)])
def test_choose_peers_matches_reference(me, k, local):
    addrs = {str(w): {"host": f"h{w // 2}"} for w in range(6)}
    addrs["5"] = {}
    assert peerstate.choose_peers(me, addrs, k, local_size=local) == \
        ref_ps.choose_peers(me, addrs, k, local_size=local)


def _state(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 5)).astype(np.float32),
                       "b": rng.standard_normal(5).astype(np.float32)},
            "count": np.int32(seed), "step": seed}


def test_manifests_and_markers_byte_equal_reference(rdv, monkeypatch):
    server, made = rdv
    monkeypatch.setattr(ref_ps.time, "time", lambda: 1234.5)
    monkeypatch.setattr(peerstate.time, "time", lambda: 1234.5)
    keys = {}
    for name, mod in (("ref", ref_ps), ("port", peerstate)):
        peers = [_manager(mod, server, made, w, int(w)) for w in ("1", "2")]
        me = _manager(mod, server, made, "0", 0)
        me.snapshot_sync(_state(3), 3)
        scope = server.scope_items(http_server.PEERSTATE_SCOPE)
        keys[name] = {k: v for k, v in scope.items()
                      if not k.startswith(http_server.PEER_ADDR_PREFIX)}
        for m in (me, *peers):
            m.stop()
        server.clear_scope(http_server.PEERSTATE_SCOPE)
    assert keys["port"] == keys["ref"]
    assert sorted(keys["port"]) == ["commit.3.0", "manifest.3.0"]
    manifest = json.loads(keys["port"]["manifest.3.0"])
    assert manifest["world_size"] == 1 and len(manifest["shards"]) == 3
    assert (http_server.SNAPSHOT_MANIFEST_PREFIX,
            http_server.SNAPSHOT_COMMIT_PREFIX) == \
        (ref_srv.SNAPSHOT_MANIFEST_PREFIX, ref_srv.SNAPSHOT_COMMIT_PREFIX)


def test_float32_snapshot_restores_across_packages(rdv):
    server, made = rdv
    # peers of both packages hold the replicas, on one server
    _manager(ref_ps, server, made, "1", 1)
    _manager(peerstate, server, made, "2", 2)
    ref_me = _manager(ref_ps, server, made, "0", 0)
    want = _state(4)
    ref_me.snapshot_sync(want, 4)
    port_me = _manager(peerstate, server, made, "0", 0)
    like = {"params": {"w": torch.zeros(4, 5), "b": torch.zeros(5)},
            "count": torch.zeros((), dtype=torch.int32), "step": 0}
    w = like["params"]["w"]
    got, gen = port_me.restore(like)
    assert gen == 4 and got["params"]["w"] is w and got["step"] == 4
    for k in ("w", "b"):
        assert got["params"][k].numpy().tobytes() == \
            want["params"][k].tobytes()
    assert int(got["count"]) == 4

    port_state = {"params": {"w": torch.randn(4, 5), "b": torch.randn(5)},
                  "count": torch.tensor(9, dtype=torch.int32), "step": 9}
    port_me.snapshot_sync(port_state, 9)
    back, gen = ref_me.restore()
    assert gen == 9 and back["step"] == 9
    for k in ("w", "b"):
        assert isinstance(back["params"][k], np.ndarray)
        assert back["params"][k].tobytes() == \
            port_state["params"][k].numpy().tobytes()


def test_in_place_mutation_after_snapshot_restores_enqueue_values(rdv):
    server, made = rdv
    for w in ("1", "2"):
        _manager(peerstate, server, made, w, int(w))
    me = _manager(peerstate, server, made, "0", 0)
    state = {"w": torch.arange(6, dtype=torch.float32),
             "h": torch.full((3,), 1.5, dtype=torch.bfloat16), "step": 5}
    me.snapshot(state, 5)
    state["w"].add_(100)  # the step's in-place update, after the enqueue
    state["h"].mul_(3)
    state["step"] = 6
    assert me.drain(30)
    me.snapshot(state, 6)
    state["w"].add_(100)
    assert me.drain(30) and me.failures == 0 and me.snapshots == 2
    like = {"w": torch.zeros(6), "h": torch.zeros(3, dtype=torch.bfloat16),
            "step": 0}
    got, gen = me.restore(like)
    assert gen == 6 and got["step"] == 6
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32) + 100)
    assert torch.equal(got["h"].view(torch.int16), torch.full(
        (3,), 4.5, dtype=torch.bfloat16).view(torch.int16))
    got, _ = me.restore(like, gen=5)
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))
    assert got["step"] == 5


def test_elastic_state_snapshots_to_peers_and_resumes_from_them(
        rdv, monkeypatch, tmp_path):
    from horovod_tpu_torch.elastic.state import ElasticState
    from horovod_tpu_torch.utils.checkpoint import latest_step

    server, made = rdv
    for w in ("1", "2"):
        _manager(peerstate, server, made, w, int(w))
    monkeypatch.setenv("HVD_SNAPSHOT", "1")
    monkeypatch.setenv("HVD_SNAPSHOT_STORAGE_EVERY", "3")
    monkeypatch.setenv("HVD_ELASTIC_WORKER_ID", "0")
    path = str(tmp_path / "ck")
    state = {"w": torch.zeros(4), "step": 0}
    es = ElasticState(path, state)
    assert es._peer is not None
    for n in range(1, 5):
        state["w"].fill_(float(n))
        es.state = dict(state, step=n)
        es.save(n)
    assert es._peer.drain(30)
    assert latest_step(path) == 4  # storage on saves 1 and 4
    assert sorted(int(d[5:]) for d in __import__("os").listdir(path)
                  if d.startswith("step_") and d[5:].isdigit()) == [1, 4]
    es2 = ElasticState(path, {"w": torch.full((4,), -1.0), "step": 0})
    got, step = es2.resume()
    assert step == 4 and torch.equal(got["w"], torch.full((4,), 4.0))
