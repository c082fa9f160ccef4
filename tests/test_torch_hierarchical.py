"""horovod_tpu_torch.parallel.hierarchical against
horovod_tpu.parallel.hierarchical.

The pure topology — ``process_group_members`` and ``process_stage_plan``
— exactly equal to the reference's over every rank of a grid of world
and local sizes (trivial and uneven splits included); the group lists
the port makes its ``torch.distributed`` groups from; the knobs'
defaults; and, at world size 1 on the CPU, the flat fallbacks (the
two-level one counted) and the allgather.  Across processes
``tests/test_torch_wire.py`` holds the reductions against the
reference's mesh.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.parallel import hierarchical as ref
from horovod_tpu_torch import core
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel import hierarchical as port

GRID = [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (6, 4), (8, 2), (8, 4),
        (12, 3), (16, 4), (16, 8)]


@pytest.mark.parametrize("size,local_size", GRID)
def test_stage_plan_matches_reference(size, local_size):
    for rank in range(size):
        got = port.process_stage_plan("allreduce", rank=rank, size=size,
                                      local_size=local_size)
        want = ref.process_stage_plan("allreduce", rank=rank, size=size,
                                      local_size=local_size)
        if want is None:
            assert got is None
            continue
        assert [(s.op, s.group, s.peers) for s in got] == \
            [(s.op, s.group, s.peers) for s in want]


@pytest.mark.parametrize("size,local_size", [g for g in GRID
                                             if g[0] % g[1] == 0])
def test_group_members_match_reference(size, local_size):
    for rank in range(size):
        assert port.process_group_members(rank, size, local_size) == \
            ref.process_group_members(rank, size, local_size)


@pytest.mark.parametrize("env,want", [({}, None), ({"HVD_LOCAL_SIZE": "2"},
                                                   "plan")])
def test_stage_plan_reads_the_local_size_knob(monkeypatch, env, want):
    monkeypatch.delenv("HVD_LOCAL_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = port.process_stage_plan(rank=1, size=4)
    ref_got = ref.process_stage_plan(rank=1, size=4)
    assert (got is None) == (ref_got is None) == (want is None)


@pytest.fixture()
def world_of(monkeypatch):
    """A port world of one CPU rank with the given local size."""
    for k in ("HVD_COORDINATOR_ADDR", "HVD_NUM_PROCESSES", "HVD_PROCESS_ID",
              "HVD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    core.shutdown()
    core.init(device="cpu")
    yield
    core.shutdown()


def test_group_lists_are_the_references_layout(world_of, monkeypatch):
    monkeypatch.setattr(core, "local_size", lambda: 2)
    monkeypatch.setattr(core, "cross_size", lambda: 3)
    assert port._local_groups() == [[0, 1], [2, 3], [4, 5]]
    assert port._cross_groups_for_chunk() == [[0, 2, 4], [1, 3, 5]]


@pytest.mark.parametrize("op", ["Average", "Sum"])
def test_world_of_one_reductions(world_of, op):
    x = torch.randn(7)
    np.testing.assert_array_equal(port.hierarchical_allreduce(x, op=op), x)
    before = port.FALLBACKS["two_level"]
    out = port.two_level_allreduce(x, op=op, compression=Compression.int8)
    assert port.FALLBACKS["two_level"] == before + 1
    # one rank: the quantizer's whole range, int8 exact to half a step
    assert torch.allclose(out, x, atol=x.abs().max().item() / 127)
    np.testing.assert_array_equal(port.hierarchical_allgather(x[None]),
                                  x[None].numpy())


def test_min_max_refused(world_of):
    for op in ("Min", "Max"):
        with pytest.raises(ValueError):
            port.hierarchical_allreduce(torch.ones(2), op=op)
        with pytest.raises(ValueError):
            port.two_level_allreduce(torch.ones(2), op=op)


@pytest.mark.parametrize("name,env", [
    ("use_two_level_default", "HVD_TWO_LEVEL_ALLREDUCE"),
    ("use_hierarchical_default", "HVD_HIERARCHICAL_ALLREDUCE"),
])
@pytest.mark.parametrize("value", [None, "1", "0"])
def test_default_knobs_match_reference(monkeypatch, name, env, value):
    monkeypatch.delenv(env, raising=False)
    if value is not None:
        monkeypatch.setenv(env, value)
    assert getattr(port, name)() == getattr(ref, name)()


def test_groups_are_made_once_a_world_and_stale_ones_raise(world_of):
    g = port.groups()
    assert port.groups() is g and g.local is not None
    core.reinit()
    with pytest.raises(RuntimeError, match="reinit"):
        g.local
    fresh = port.groups()
    assert fresh is not g and fresh.cross is not None
