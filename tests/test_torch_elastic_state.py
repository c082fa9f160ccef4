"""horovod_tpu_torch.elastic.state.ElasticState against the reference's:
the same script of saves and resumes, decision by decision.

Each scenario runs once with each package over its own rendezvous server
and two peer managers of the same package: which saves wrote the storage
tier (``step_N`` on disk), which tier each ``resume()`` restored from
(``restore.source``: peer or storage) and at which step, and the values
it restored.  The reference's state is numpy, the port's torch tensors
restored in place.

* the peer tier off: every save is a storage save, resume takes the
  newest committed step;
* on (``HVD_SNAPSHOT=1``, ``HVD_SNAPSHOT_STORAGE_EVERY=3``): every save a
  peer snapshot, storage on saves 0 and 3, resume from the peers at the
  newest generation;
* on, with ``kind=corrupt`` at ``peer_push``: every replica fails its
  checksum, and resume falls back to the storage tier's newest step;
* a fresh run: nothing to resume, step 0 and the initial state.
"""

import os

import numpy as np
import pytest
import torch

from horovod_tpu.elastic import faults as ref_faults
from horovod_tpu.elastic import membership as ref_membership
from horovod_tpu.elastic import peerstate as ref_peerstate
from horovod_tpu.elastic import state as ref_state
from horovod_tpu_torch.elastic import faults, membership, peerstate, state
from horovod_tpu_torch.run.http_server import RendezvousServer

SECRET = b"elastic-state"
PKGS = {"ref": (ref_state, ref_peerstate, ref_membership, ref_faults),
        "port": (state, peerstate, membership, faults)}


def _value(pkg: str, x: float):
    return {"w": np.full(3, x, np.float32)} if pkg == "ref" \
        else {"w": torch.full((3,), x)}


def _read(pkg: str, tree) -> list:
    w = tree["w"]
    return np.asarray(w if pkg == "ref" else w.numpy()).tolist()


def _scenario(pkg: str, kind: str, root, monkeypatch) -> list:
    st, ps, mb, fl = PKGS[pkg]
    server = RendezvousServer(secret=SECRET)
    port = server.start()
    env = {"HVD_METRICS_KV_ADDR": "127.0.0.1",
           "HVD_METRICS_KV_PORT": str(port),
           "HVD_METRICS_SECRET": SECRET.hex(), "HVD_RING_HOST": "127.0.0.1",
           "HVD_NUM_PROCESSES": "1", "HVD_PROCESS_ID": "0",
           "HVD_ELASTIC_WORKER_ID": "0", "HVD_SNAPSHOT_STORAGE_EVERY": "3",
           "HVD_SNAPSHOT": "0" if kind in ("off", "fresh") else "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if kind == "corrupt":
        monkeypatch.setenv("HVD_FAULT_SPEC",
                           "kind=corrupt:seam=peer_push:restart=*")
    else:
        monkeypatch.delenv("HVD_FAULT_SPEC", raising=False)
    fl.reset()
    mb._reset_for_tests()
    ps.reset()
    sources = []
    record = st.ElasticState._record_restore
    monkeypatch.setattr(st.ElasticState, "_record_restore",
                        lambda self, source, extra: (sources.append(source),
                                                     record(self, source,
                                                            extra)))
    peers = [ps.PeerSnapshotManager(addr="127.0.0.1", port=port,
                                    secret=SECRET, worker=w, rank=int(w))
             for w in ("1", "2")]
    for p in peers:
        p.start()
    path = str(root / pkg / kind)
    out = []
    try:
        es = st.ElasticState(path, _value(pkg, 0.0))
        out.append(("peer", es._peer is not None))
        if kind != "fresh":
            for n in range(1, 6):
                es.state = _value(pkg, float(n))
                out.append(("save", n, es.save(n) is not None))
            if es._peer is not None:
                assert es._peer.drain(30)
        out.append(("on_disk", sorted(
            int(d[5:]) for d in (os.listdir(path) if os.path.isdir(path)
                                 else ()) if d[5:].isdigit())))
        es2 = st.ElasticState(path, _value(pkg, -1.0))
        got, step = es2.resume()
        out.append(("resume", step, list(sources), _read(pkg, got)))
    finally:
        ps.reset()
        for p in peers:
            p.stop()
        fl.reset()
        mb._reset_for_tests()
        server.stop()
    return out


@pytest.mark.parametrize("kind", ["off", "peer", "corrupt", "fresh"])
def test_save_demotion_and_resume_decisions_equal_reference(
        kind, tmp_path, monkeypatch):
    want = _scenario("ref", kind, tmp_path, monkeypatch)
    got = _scenario("port", kind, tmp_path, monkeypatch)
    assert got == want
    resume = got[-1]
    if kind == "peer":
        assert resume == ("resume", 5, ["peer"], [5.0] * 3)
        assert got[-2] == ("on_disk", [1, 4])
    elif kind == "corrupt":
        assert resume == ("resume", 4, ["storage"], [4.0] * 3)
    elif kind == "off":
        assert resume == ("resume", 5, [], [5.0] * 3)
    else:
        assert resume == ("resume", 0, [], [-1.0] * 3)


def test_restart_count_and_in_place_resume(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_RESTART_COUNT", "2")
    monkeypatch.setenv("HVD_SNAPSHOT", "0")
    es = state.ElasticState(str(tmp_path), _value("port", 7.0))
    assert es.restart_count == ref_state.ElasticState(
        str(tmp_path), {}).restart_count == 2
    es.save(7)
    like = _value("port", 0.0)
    w = like["w"]
    got, step = state.ElasticState(str(tmp_path), like).resume()
    assert step == 7 and got["w"] is w and torch.equal(w, torch.full((3,),
                                                                    7.0))
