"""horovod_tpu_torch.utils.checkpoint against horovod_tpu.utils.checkpoint.

* ``latest_step`` over the same directory fixtures gives the reference's
  answer: junk names, torn ``step_N`` dirs (no ``COMMITTED`` sentinel),
  the overwrite's un-commit, missing and empty paths, and directories
  the reference itself wrote (orbax content: the listing protocol is
  shared, the content format is not).
* save / restore round trips: every tensor (float32, bfloat16, int32, on
  its device) comes back into the template's tensors in place, scalars
  and numpy leaves as saved; a save that dies after the un-commit leaves
  the step uncommitted; ``force=False`` refuses an overwrite.
* the multi-process agreement round of ``restore_checkpoint`` (the
  reference's ``:181-234``), with the process plane monkeypatched as the
  reference's own tests do: a rank-0 failure raises on every rank, an
  unreadable non-root takes root's tree by ``broadcast_object``, every
  rank readable takes ``broadcast_parameters``;
* the port's ImageNet recipe (``examples/pytorch_imagenet_resnet50.py``)
  refuses a batch that does not divide by the accumulation, and resumes
  from rank 0's checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from horovod_tpu.utils import checkpoint as ref_ck
from horovod_tpu_torch import core, eager
from horovod_tpu_torch.utils import checkpoint as ck


def _fixture(root, kind: str):
    """One directory layout by name; returns its path."""
    path = root / kind
    path.mkdir()
    if kind == "junk":
        for name in ("step_1", "step_10", "step_2", "step_x", "other",
                     "step_"):
            (path / name).mkdir()
        for step in (1, 10, 2):
            (path / f"step_{step}.COMMITTED").write_bytes(b"1")
    elif kind == "torn":
        for name in ("step_4", "step_7"):
            (path / name).mkdir()
        (path / "step_4.COMMITTED").write_bytes(b"1")
    elif kind == "uncommitted":
        (path / "step_3").mkdir()
    elif kind == "uncommit_overwrite":
        for step in (4, 7):
            (path / f"step_{step}").mkdir()
            (path / f"step_{step}.COMMITTED").write_bytes(b"1")
        os.remove(path / "step_7.COMMITTED")  # the overwrite's first half
    elif kind == "file_named_step":
        (path / "step_9").write_bytes(b"not a dir")
        (path / "step_9.COMMITTED").write_bytes(b"1")
    return str(path)


@pytest.mark.parametrize("kind", ["junk", "torn", "uncommitted",
                                  "uncommit_overwrite", "file_named_step",
                                  "empty"])
def test_latest_step_matches_reference(tmp_path, kind):
    path = _fixture(tmp_path, kind)
    assert ck.latest_step(path) == ref_ck.latest_step(path)


def test_latest_step_of_a_missing_path_is_none(tmp_path):
    missing = str(tmp_path / "never-written")
    assert ck.latest_step(missing) is None is ref_ck.latest_step(missing)


def test_latest_step_over_directories_the_reference_wrote(tmp_path):
    """The reference's saves (orbax content, its sentinels), one torn by
    hand: both packages resume from the same step."""
    path = str(tmp_path)
    for step in (2, 5):
        ref_ck.save_checkpoint(path, {"w": np.full(2, float(step))},
                               step=step)
    assert ck.latest_step(path) == ref_ck.latest_step(path) == 5
    ref_ck.clear_commit_marker(path, 5)
    assert ck.latest_step(path) == ref_ck.latest_step(path) == 2
    ck.write_commit_marker(path, 5)
    assert ref_ck.is_committed(path, 5) and ck.is_committed(path, 5)
    assert ck.commit_marker_path(path, 5) == ref_ck.commit_marker_path(
        path, 5)


def _state(fill: float):
    return {"params": {"w": torch.full((3, 2), fill),
                       "b": torch.full((2,), fill, dtype=torch.bfloat16)},
            "count": torch.tensor(int(fill), dtype=torch.int32),
            "host": np.full(2, fill), "step": int(fill)}


def test_save_and_restore_round_trip_into_the_template(tmp_path):
    path = str(tmp_path)
    assert ck.save_checkpoint(path, _state(3.0), step=3).endswith("step_3")
    assert ck.is_committed(path, 3) and ck.latest_step(path) == 3
    like = _state(0.0)
    tensors = [like["params"]["w"], like["params"]["b"], like["count"]]
    out = ck.restore_checkpoint(path, like, broadcast=False)
    assert [out["params"]["w"], out["params"]["b"], out["count"]] == tensors
    assert out["params"]["w"] is tensors[0]  # loaded in place
    assert torch.equal(out["params"]["w"], torch.full((3, 2), 3.0))
    assert out["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["b"],
                       torch.full((2,), 3.0, dtype=torch.bfloat16))
    assert int(out["count"]) == 3 and out["step"] == 3
    np.testing.assert_array_equal(out["host"], np.full(2, 3.0))


def test_restore_refuses_another_structure(tmp_path):
    ck.save_checkpoint(str(tmp_path), _state(1.0), step=1)
    with pytest.raises(ValueError, match="keys"):
        ck.restore_checkpoint(str(tmp_path), {"w": torch.zeros(2)},
                              broadcast=False)


def test_crash_mid_overwrite_is_never_resumed(tmp_path, monkeypatch):
    """An overwrite un-commits first: a save that dies while writing
    leaves the step uncommitted, and resume takes the step before."""
    path = str(tmp_path)
    ck.save_checkpoint(path, _state(4.0), step=4)
    ck.save_checkpoint(path, _state(5.0), step=5)

    def die(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", die)
    with pytest.raises(OSError):
        ck.save_checkpoint(path, _state(6.0), step=5)
    assert not ck.is_committed(path, 5)
    assert ck.latest_step(path) == ref_ck.latest_step(path) == 4
    monkeypatch.undo()
    out = ck.restore_checkpoint(path, _state(0.0), broadcast=False)
    assert out["step"] == 4


def test_force_false_refuses_an_overwrite(tmp_path):
    ck.save_checkpoint(str(tmp_path), _state(1.0), step=1)
    with pytest.raises(FileExistsError):
        ck.save_checkpoint(str(tmp_path), _state(2.0), step=1, force=False)


def test_single_process_failure_raises_directly(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(str(tmp_path / "nope"), _state(0.0),
                              broadcast=False)


@pytest.fixture()
def fake_multi(monkeypatch):
    """A simulated 2-process world, as the reference's tests fake it."""
    monkeypatch.setattr(core, "is_initialized", lambda: True)
    monkeypatch.setattr(core, "process_size", lambda: 2)
    monkeypatch.setattr(core, "process_rank", lambda: 0)
    monkeypatch.setattr(eager, "broadcast_object", lambda obj, *a, **k: obj)
    return monkeypatch


def test_root_restore_failure_surfaces_on_every_rank(fake_multi, tmp_path):
    calls = []

    def agree(status, **k):
        calls.append(status)
        return [status, None]

    fake_multi.setattr(eager, "allgather_object", agree)
    with pytest.raises(RuntimeError, match="rank 0 failed to restore"):
        ck.restore_checkpoint(str(tmp_path / "nope"), _state(0.0))
    assert len(calls) == 1 and calls[0] is not None


def test_nonroot_unreadable_takes_roots_tree(fake_multi, tmp_path):
    fake_multi.setattr(core, "process_rank", lambda: 1)
    fake_multi.setattr(eager, "allgather_object",
                       lambda status, **k: [None, status])
    shipped = []

    def bcast(obj, *a, **k):
        shipped.append(obj)
        return ck.to_cpu(_state(7.0))

    fake_multi.setattr(eager, "broadcast_object", bcast)
    like = _state(0.0)
    out = ck.restore_checkpoint(str(tmp_path / "nope"), like, step=5)
    assert out["params"]["w"] is like["params"]["w"]
    assert torch.equal(like["params"]["w"], torch.full((3, 2), 7.0))
    assert shipped == [None] and out["step"] == 7


def test_all_ranks_readable_takes_broadcast_parameters(fake_multi,
                                                       tmp_path):
    ck.save_checkpoint(str(tmp_path), _state(4.0), step=4)
    fake_multi.setattr(eager, "allgather_object",
                       lambda status, **k: [None, None])
    from horovod_tpu_torch.optim import distributed as dist

    seen = []

    def bparams(tree, *a, **k):
        seen.append(tree)
        return tree

    fake_multi.setattr(dist, "broadcast_parameters", bparams)
    out = ck.restore_checkpoint(str(tmp_path), _state(0.0))
    assert torch.equal(out["params"]["w"], torch.full((3, 2), 4.0))
    assert len(seen) == 1


def test_numpy_wire_form_holds_bfloat16_exactly():
    """``to_numpy`` (the peer plane's wire form) carries bfloat16 as
    float32; ``load_into`` casts it back without loss."""
    t = torch.randn(64).to(torch.bfloat16)
    wire = ck.to_numpy({"t": t})["t"]
    assert wire.dtype == np.float32
    back = ck.load_into({"t": torch.zeros(64, dtype=torch.bfloat16)},
                        {"t": wire})["t"]
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))


def test_imagenet_recipe_refuses_uneven_accumulation_and_resumes(
        tmp_path, monkeypatch):
    """The port's ImageNet recipe: ``--batch-size`` must divide by
    ``--batches-per-allreduce`` (the reference's fault at its :214 is
    not copied), and a second run resumes at the epoch rank 0's
    checkpoint names, through ``broadcast_object``.  The recipe's logic
    is under test, not the model: its ResNet-50 is narrowed to one block
    a stage at width 8 (the full one takes minutes on a loaded CPU)."""
    from horovod_tpu_torch.examples import pytorch_imagenet_resnet50 as ex

    narrow = ex._resnet
    monkeypatch.setattr(ex, "_resnet", lambda layers, classes, bottleneck:
                        narrow([1, 1, 1, 1], classes, bottleneck, width=8))

    with pytest.raises(SystemExit):
        ex.parse_args(["--batch-size", "5", "--batches-per-allreduce", "2"])
    argv = ["--device", "cpu", "--image-size", "32", "--batch-size", "4",
            "--batches-per-allreduce", "2", "--num-classes", "10",
            "--steps-per-epoch", "1", "--checkpoint-format",
            str(tmp_path / "ck-{epoch}.pt")]
    core.shutdown()
    try:
        first = ex.run(ex.parse_args(argv + ["--epochs", "1"]))
        assert first["epochs_run"] == 1 and np.isfinite(first["last_loss"])
        assert (tmp_path / "ck-1.pt").exists()
        second = ex.run(ex.parse_args(argv + ["--epochs", "2"]))
        assert second["epochs_run"] == 1 and (tmp_path / "ck-2.pt").exists()
    finally:
        core.shutdown()
