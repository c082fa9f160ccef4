"""horovod_tpu_torch.callbacks against horovod_tpu.callbacks.

The warm-up and schedule callbacks' ``lr(step)`` equal to the
reference's over 40 steps; the warm-up's ``as_optax_schedule`` on the
port's int32 count tensor equal to the reference's schedule on jnp
counts (float32, bit for bit); and optax's ``sgd`` driven by that
schedule against the port's ``transforms.sgd`` with the port's schedule,
evaluated from the transforms' device count, over 6 steps (1e-6).  At
one rank: the metric average and the broadcast callback.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import callbacks as ref
from horovod_tpu_torch import callbacks as port
from horovod_tpu_torch import core
from horovod_tpu_torch.optim import transforms
from horovod_tpu_torch.optim.fused_update import apply_updates


@pytest.fixture()
def port_cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


WARMUPS = [dict(initial_lr=0.1, multiplier=4.0, warmup_epochs=2,
                steps_per_epoch=5),
           dict(initial_lr=0.01, multiplier=8.0, warmup_epochs=0.5,
                steps_per_epoch=7),
           dict(initial_lr=1.0, multiplier=1.0)]


@pytest.mark.parametrize("kw", WARMUPS)
def test_warmup_lr_and_schedule_match_reference(kw):
    r, p = ref.LearningRateWarmupCallback(**kw), \
        port.LearningRateWarmupCallback(**kw)
    assert [r.lr(s) for s in range(40)] == [p.lr(s) for s in range(40)]
    rs, ps = r.as_optax_schedule(), p.as_optax_schedule()
    for s in range(40):
        want = np.float32(rs(jnp.int32(s)))
        got = ps(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy() == want, s


@pytest.mark.parametrize("kw", [
    dict(initial_lr=0.1, multiplier=0.5, start_epoch=2, end_epoch=5,
         steps_per_epoch=3),
    dict(initial_lr=0.1, multiplier=lambda e: 0.9 ** e, staircase=False,
         steps_per_epoch=4),
    dict(initial_lr=0.2, multiplier=2.0, start_epoch=1),
])
def test_schedule_callback_matches_reference(kw):
    r, p = ref.LearningRateScheduleCallback(**kw), \
        port.LearningRateScheduleCallback(**kw)
    assert [r.lr(s) for s in range(40)] == [p.lr(s) for s in range(40)]


def test_sgd_on_the_warmup_schedule_matches_optax():
    kw = WARMUPS[0]
    rng = np.random.default_rng(8)
    w = rng.normal(size=(5,)).astype(np.float32)
    grads = [rng.normal(size=(5,)).astype(np.float32) for _ in range(6)]
    opt = optax.sgd(ref.LearningRateWarmupCallback(**kw).as_optax_schedule(),
                    momentum=0.9)
    pw, state = jnp.asarray(w), None
    state = opt.init(pw)
    for g in grads:
        u, state = opt.update(jnp.asarray(g), state, pw)
        pw = optax.apply_updates(pw, u)
    t = transforms.sgd(port.LearningRateWarmupCallback(**kw)
                       .as_optax_schedule(), momentum=0.9)
    tw = {"w": torch.from_numpy(w.copy())}
    tstate = t.init(tw)
    for g in grads:
        u, tstate = t.update({"w": torch.from_numpy(g)}, tstate, tw)
        apply_updates(tw, u)
    assert int(tstate[1].count) == len(grads)
    np.testing.assert_allclose(tw["w"].numpy(), np.asarray(pw), rtol=1e-6,
                               atol=1e-7)


def test_one_rank_callbacks(port_cpu_world):
    metrics = {"loss": 1.5, "acc": 0.25}
    assert port.MetricAverageCallback().on_epoch_end(0, None, metrics) == \
        metrics
    cb = port.BroadcastGlobalVariablesCallback(root_rank=0)
    state = {"w": torch.ones(2)}
    assert cb.on_train_begin(state) is state and cb.broadcast_done
    base = port.Callback()
    assert base.on_train_begin(state) is state
    assert base.on_batch_end(3, state) is state
    assert base.on_epoch_end(0, state, metrics) is metrics
