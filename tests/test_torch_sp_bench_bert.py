"""The BERT bench's ``--seq-parallel ring|ulysses`` on 2 gloo ranks against
the reference bench's sequence-parallel path on a 2-device CPU mesh
(tests/sp_bench_reference.py says how)."""

import pytest

import sp_bench_reference as spb

BENCH = "bert"


@pytest.fixture(scope="module")
def port_losses(tmp_path_factory):
    return spb.port_losses(BENCH, tmp_path_factory.mktemp("sp_bench"))


@pytest.fixture(scope="module")
def reference_losses():
    return spb.reference_losses(BENCH)


@pytest.mark.parametrize("sp,attn", spb.runs(BENCH))
def test_sequence_parallel_loss_matches_reference(port_losses,
                                                  reference_losses, sp,
                                                  attn):
    spb.check(port_losses, reference_losses, BENCH, sp, attn)
