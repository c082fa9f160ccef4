"""horovod_tpu_torch.data.loader against horovod_tpu.data.loader.

* ``pad_tail`` gives the reference's arrays and Join mask.
* ``ShardedLoader``: rank r of the port yields rows ``[r·b, (r+1)·b)``
  of each global batch the reference places across its mesh (8 CPU
  devices, shuffled and not, with an uneven tail), and the same
  ``active`` mask; the port's ranks are emulated in one process by
  setting the rank its ``core`` reports.
* ``prefetch_to_device`` keeps the reference's order and values, ahead
  of the consumer or synchronously, re-raises a producer error at the
  consumer, and on the CPU yields the CPU tensors.  The card's side
  stream is checked by ``chip_smoke.py``'s ``autotune`` phase and by the
  test marked ``cuda``.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.data import loader as ref
from horovod_tpu_torch import core
from horovod_tpu_torch.data import loader as port


@pytest.mark.parametrize("valid,b,size", [(16, 4, 4), (13, 4, 4), (5, 4, 4),
                                          (1, 3, 2), (7, 2, 8)])
def test_pad_tail_matches_reference(valid, b, size):
    rng = np.random.default_rng(valid)
    cols = [rng.normal(size=(valid, 3)).astype(np.float32),
            rng.integers(0, 9, size=(valid,)).astype(np.int32)]
    (pc, pr), (rc, rr) = port.pad_tail(cols, valid, b, size), \
        ref.pad_tail(cols, valid, b, size)
    assert np.array_equal(pr, rr)
    for a, c in zip(pc, rc):
        assert a.dtype == c.dtype and np.array_equal(a, c)


@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_sharded_loader_gives_each_rank_its_reference_rows(
        hvd_init, cpu_world, monkeypatch, shuffle, drop_remainder):
    n, b, size = 70, 3, 8          # 24 rows a global batch, a tail of 22
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.arange(n, dtype=np.int64)
    want = [tuple(np.asarray(a) for a in batch) for batch in
            ref.ShardedLoader(x, y, batch_size=b, shuffle=shuffle, seed=3,
                              drop_remainder=drop_remainder, prefetch=0)]
    monkeypatch.setattr(core, "size", lambda: size)
    for r in range(size):
        monkeypatch.setattr(core, "rank", lambda r=r: r)
        loader = port.ShardedLoader(x, y, batch_size=b, shuffle=shuffle,
                                    seed=3, drop_remainder=drop_remainder,
                                    prefetch=2)
        got = list(loader)
        assert len(got) == len(want) == len(loader)
        for (gx, gy, gact), (wx, wy, wact) in zip(got, want):
            assert np.array_equal(gx.numpy(), wx[r * b:(r + 1) * b])
            assert np.array_equal(gy.numpy(), wy[r * b:(r + 1) * b])
            assert np.array_equal(gact.numpy(), wact)


def _batches(n=9):
    rng = np.random.default_rng(11)
    for i in range(n):
        yield (rng.normal(size=(2, 3)).astype(np.float32),
               {"y": np.full((2,), i, np.int64)})


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_keeps_the_reference_order_and_values(depth):
    want = list(ref.prefetch_to_device(_batches(), depth))
    got = list(port.prefetch_to_device(_batches(), depth, device="cpu"))
    assert len(got) == len(want) == 9
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        assert np.array_equal(gx.numpy(), wx)
        assert np.array_equal(gy["y"].numpy(), wy["y"])


def test_prefetch_reraises_a_producer_error_and_stops_early():
    def bad():
        yield np.zeros(2)
        raise ValueError("planted")

    it = port.prefetch_to_device(bad(), 2, device="cpu")
    assert torch.equal(next(it), torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="planted"):
        next(it)
    early = port.prefetch_to_device(_batches(), 2, device="cpu")
    next(early)
    early.close()
    assert list(early) == []


def test_prefetch_defaults_to_the_worlds_device(cpu_world):
    it = port.prefetch_to_device(_batches(3), 1)
    assert it.device == torch.device("cpu") and it.stream is None
    assert len(list(it)) == 3


@pytest.mark.cuda
def test_prefetch_copies_on_a_side_stream_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    it = port.prefetch_to_device(_batches(4), 2, device="cuda")
    assert it.stream is not None
    assert it.stream != torch.cuda.default_stream()
    got = list(it)
    for (gx, gy), (wx, wy) in zip(got, _batches(4)):
        assert gx.is_cuda and np.array_equal(gx.cpu().numpy(), wx)
