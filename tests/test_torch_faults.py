"""horovod_tpu_torch.elastic.faults against horovod_tpu.elastic.faults: the
``HVD_FAULT_SPEC`` grammar, the seeded draws, and the seams the port
wires.

* a table of spec strings parses to equal ``Fault`` lists, and the same
  malformed specs raise ``FaultSpecError`` in both;
* seeded probabilistic faults (``HVD_FAULT_SEED`` mixed with rank and
  incarnation) fire at the same invocations in both packages, for every
  seam; ``corrupt`` at ``peer_push`` flips the same bytes; a partition
  drops the http and controller seams alike;
* the port's seams: the train step's wrapper (``on_step``, beside the
  abort check), the host-plane guard (``on_dispatch``) and the
  rendezvous client's retry loop (``on_http``).
"""

import urllib.error

import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.elastic import faults as ref_faults
from horovod_tpu_torch.elastic import faults

SPECS = [
    "rank=1:step=3:kind=crash",
    "rank=*:kind=slow=200ms:prob=0.5;rank=0:step=10:kind=hang",
    "kind=http_drop:prob=0.3:restart=*",
    "rank=1:step=4:kind=partition",
    "kind=corrupt:seam=peer_push:restart=*",
    "kind=http_drop:seam=peer_pull:restart=*",
    "kind=preempt=30s:rank=2;kind=preempt",
    "rank=0:step=10:kind=hang:seam=dispatch;kind=slow=1.5s:seam=controller",
    " ; kind=slow=2m:step=*:restart=3 ;",
]

BAD = ["rank=1", "kind=explode", "kind=slow", "kind=crash=now",
       "kind=crash:step=soon", "kind=crash:prob=2.0", "kind=crash:seam=gpu",
       "kind=crash:color=red", "rank 1 kind crash", "kind=slow=fast"]


def _plain(fault_list):
    return [tuple(vars(f).values()) if hasattr(f, "__dict__")
            else (f.kind, f.seam, f.rank, f.step, f.restart, f.prob,
                  f.duration) for f in fault_list]


@pytest.mark.parametrize("spec", SPECS)
def test_parsed_faults_equal_reference(spec):
    assert _plain(faults.parse_spec(spec)) == \
        _plain(ref_faults.parse_spec(spec))


@pytest.mark.parametrize("spec", BAD)
def test_malformed_specs_raise_as_reference(spec):
    with pytest.raises(ref_faults.FaultSpecError) as want:
        ref_faults.parse_spec(spec)
    with pytest.raises(faults.FaultSpecError) as got:
        faults.parse_spec(spec)
    assert str(got.value) == str(want.value)


def _firings(mod, seam: str, rank: int, restart: int, seed: int):
    """Which of 64 invocations of ``seam`` a seeded prob=0.4 drop hits."""
    f = mod.Fault(kind="http_drop", seam=seam, restart=None, prob=0.4)
    inj = mod.FaultInjector([f], rank=rank, restart=restart, seed=seed)
    hit = []
    for i in range(64):
        try:
            inj.fire(seam, detail="x")
        except urllib.error.URLError:
            hit.append(i)
    return hit


@pytest.mark.parametrize("seam", faults.SEAMS)
@pytest.mark.parametrize("rank,restart,seed", [(0, 0, 7), (3, 2, 7),
                                               (1, 0, 12345)])
def test_seeded_firing_equals_reference(seam, rank, restart, seed):
    got = _firings(faults, seam, rank, restart, seed)
    assert got == _firings(ref_faults, seam, rank, restart, seed)
    assert 0 < len(got) < 64


def test_corrupt_flips_the_same_bytes_and_partition_drops_alike():
    data = bytes(range(256)) * 3
    outs = []
    for mod in (ref_faults, faults):
        inj = mod.FaultInjector(mod.parse_spec(
            "kind=corrupt:seam=peer_push:step=1:restart=*"), 0, 0)
        outs.append([inj.mutate("peer_push", data) for _ in range(3)])
    assert outs[0] == outs[1]
    assert outs[1][0] == data and outs[1][1] != data

    for mod in (ref_faults, faults):
        inj = mod.FaultInjector(mod.parse_spec(
            "kind=partition:step=0:restart=*"), 0, 0)
        inj.fire("step")
        assert inj.partitioned


@pytest.fixture()
def armed(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("HVD_FAULT_SPEC", spec)
        monkeypatch.setenv("HVD_PROCESS_ID", "0")
        monkeypatch.delenv("HVD_RESTART_COUNT", raising=False)
        faults.reset()
        ref_faults.reset()
    yield arm
    faults.reset()
    ref_faults.reset()


def test_env_wiring_matches_reference(armed, monkeypatch):
    armed("rank=0:kind=partition:step=1:seam=controller")
    for mod in (ref_faults, faults):
        inj = mod.instance()
        assert inj is not None and inj.rank == 0 and inj.restart == 0
        mod.on_controller("a")  # invocation 0: nothing
        with pytest.raises(TimeoutError, match="partition"):
            mod.on_controller("b")
        with pytest.raises(TimeoutError):
            mod.on_controller("c")  # partitioned from here on
    monkeypatch.setenv("HVD_FAULT_SEED", "nope")
    faults.reset()
    with pytest.raises(faults.FaultSpecError, match="HVD_FAULT_SEED"):
        faults.instance()


def test_step_seam_fires_in_the_train_step(armed):
    """``on_step`` sits in the step's wrapper: a drop at invocation 2
    raises out of the third call, before the step runs."""
    from horovod_tpu_torch import core, training
    from horovod_tpu_torch.models import MLP
    from horovod_tpu_torch.optim.fused_update import fused_sgd

    armed("kind=http_drop:seam=step:step=2")
    core.shutdown()
    core.init(device="cpu")
    try:
        model = MLP(4, (3,))
        opt = fused_sgd(0.1)
        step = training.make_train_step(apply_fn=model,
                                        loss_fn=F.cross_entropy,
                                        optimizer=opt, loss_fetch_steps=0)
        state = training.init_train_state(model, opt)
        x, y = torch.randn(2, 4), torch.tensor([0, 2])
        for _ in range(2):
            state, _ = step(state, x, y)
        with pytest.raises(urllib.error.URLError, match="step\\[2\\]"):
            step(state, x, y)
        assert state.step == 2 and step.calls["eager"] == 2
    finally:
        core.shutdown()


def test_dispatch_and_http_seams(armed, monkeypatch):
    from horovod_tpu_torch import eager
    from horovod_tpu_torch.run import http_client

    armed("kind=http_drop:seam=dispatch:step=1:restart=*")
    with eager._host_guard("t.0", "X", "allreduce", "star", 4):
        pass
    with pytest.raises(urllib.error.URLError, match="t.1"):
        with eager._host_guard("t.1", "X", "allreduce", "star", 4):
            pass

    # the rendezvous client's retry loop: every attempt dropped
    armed("kind=http_drop:restart=*")
    monkeypatch.setenv("HVD_HTTP_RETRIES", "2")
    monkeypatch.setenv("HVD_HTTP_BACKOFF_MS", "1")
    with pytest.raises(urllib.error.URLError, match="injected http_drop"):
        http_client.get_kv("127.0.0.1", 1, "s", "k")
    assert faults.instance()._counts["http"] == 3
