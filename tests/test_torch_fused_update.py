"""horovod_tpu_torch.optim.fused_update against the reference.

On the CPU the port's fused path runs K1's plain PyTorch version; it is
held against the reference's Pallas kernel (interpret mode, as
tests/test_fused_update.py runs it) and against ``numpy_fused_update``,
at the reference's own pinned tolerance rtol 2e-6 / atol 1e-7 (the
expressions are order-identical; only float32 rounding of the bias
corrections' power, and the oracle's division where the kernel
multiplies, can differ).  The per-leaf path equals the fused one bit for
bit, as the reference pins within itself.  K1 itself runs only on the
card: its test is marked ``cuda`` and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.optim import fused_update as ref_fu
from horovod_tpu_torch import kernels
from horovod_tpu_torch.convert import (
    Layout, fused_opt_state_from_flax, to_flax_layout, to_torch_layout,
)
from horovod_tpu_torch.optim import fused_update as fu

RTOL, ATOL = 2e-6, 1e-7

RULES = {
    "sgd": (ref_fu.fused_sgd(0.1), fu.fused_sgd(0.1)),
    "momentum": (ref_fu.fused_sgd(0.1, momentum=0.9),
                 fu.fused_sgd(0.1, momentum=0.9)),
    "adam": (ref_fu.fused_adam(1e-3), fu.fused_adam(1e-3)),
}

# ragged on purpose: no leaf and no total is a multiple of 128 lanes
SHAPES = {"a": {"w": (7, 5), "b": (5,)}, "c": (300,), "d": (1001,),
          "e": (13, 17)}


def _make(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _make(rng, v) for k, v in shapes.items()}
    return rng.normal(size=shapes).astype(np.float32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tleaves(tree):
    from horovod_tpu_torch.utils.tree import tree_flatten

    return [t.numpy() for t in tree_flatten(tree)[0]]


@pytest.fixture()
def problem():
    rng = np.random.default_rng(1234)
    params = _make(rng, SHAPES)
    grads = [_make(rng, SHAPES) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("rule", list(RULES))
def test_plain_flat_path_matches_pallas_kernel(rule, problem, monkeypatch):
    ref_opt, opt = RULES[rule]
    params, grads = problem
    monkeypatch.setenv("HVD_FUSED_UPDATE_PALLAS", "1")
    step = jax.jit(lambda g, s, p: ref_opt.fused_update(g, s, p))
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp)
    tp = _to_torch(params)
    ts = opt.init(tp)
    for g in grads:
        rp, rs = step(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
        tp, ts = opt.fused_update(_to_torch(g), ts, tp)
        for a, b in zip(_tleaves(tp), _leaves(rp)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert ts.count == int(rs.count) == 3
    for name in rs.mu:
        np.testing.assert_allclose(ts.mu[name].numpy(), np.asarray(
            rs.mu[name]), rtol=RTOL, atol=ATOL)
    for name in rs.nu:
        np.testing.assert_allclose(ts.nu[name].numpy(), np.asarray(
            rs.nu[name]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rule", list(RULES))
def test_plain_flat_path_matches_numpy_oracle(rule, problem):
    ref_opt, opt = RULES[rule]
    params, grads = problem
    np_p, np_state = params, None
    tp = _to_torch(params)
    ts = opt.init(tp)
    for g in grads:
        np_p, np_state = ref_fu.numpy_fused_update(ref_opt, np_p, g,
                                                   np_state)
        tp, ts = opt.fused_update(_to_torch(g), ts, tp)
    for a, b in zip(_tleaves(tp), _leaves(np_p)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rule", list(RULES))
def test_per_leaf_path_is_bit_identical_to_fused(rule, problem):
    _, opt = RULES[rule]
    params, grads = problem
    fused_p, leaf_p = _to_torch(params), _to_torch(params)
    fs, ls = opt.init(fused_p), opt.init(leaf_p)
    for g in grads:
        fused_p, fs = opt.fused_update(_to_torch(g), fs, fused_p)
        upd, ls = opt.update(_to_torch(g), ls, leaf_p)
        fu.apply_updates(leaf_p, upd)
    for a, b in zip(_tleaves(fused_p), _tleaves(leaf_p)):
        assert np.array_equal(a, b)
    for name in fs.mu:
        assert torch.equal(fs.mu[name], ls.mu[name])
    for name in fs.nu:
        assert torch.equal(fs.nu[name], ls.nu[name])


def test_fused_update_is_in_place(problem):
    _, opt = RULES["momentum"]
    params, grads = problem
    tp = _to_torch(params)
    w = tp["a"]["w"]
    st = opt.init(tp)
    mu = st.mu["float32"]
    out, st2 = opt.fused_update(_to_torch(grads[0]), st, tp)
    assert out["a"]["w"] is w and st2.mu["float32"] is mu
    assert not np.array_equal(w.numpy(), params["a"]["w"])


@pytest.mark.parametrize("rule", list(RULES))
def test_converted_reference_state_continues_identically(rule):
    """A reference state (flax layouts: HWIO conv, [in, out] dense) after
    two steps, carried across by convert.py: the port's next step matches
    the reference's next step."""
    ref_opt, opt = RULES[rule]
    rng = np.random.default_rng(9)
    shapes = {"Conv_0": {"kernel": (3, 3, 2, 4)},
              "Dense_0": {"kernel": (6, 5), "bias": (5,)}}
    params = _make(rng, shapes)
    grads = [_make(rng, shapes) for _ in range(3)]
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp)
    for g in grads[:2]:
        rp, rs = ref_opt.fused_update(jax.tree_util.tree_map(jnp.asarray, g),
                                      rs, rp)

    def torch_canonical(tree):
        flat = {f"{m}/{k}": v for m, sub in tree.items()
                for k, v in sub.items()}
        return {k: torch.from_numpy(np.array(to_torch_layout(
            np.asarray(flat[k])))) for k in sorted(flat)}

    tp = torch_canonical(rp)
    # the Conv / Dense rule, as canonical_layouts gives it for these layers
    layouts = {k: Layout.of_rank(t.shape) for k, t in tp.items()}
    ts = fused_opt_state_from_flax(rs.count, rs.mu, rs.nu, tp, layouts)
    assert ts.count == 2
    rp, rs = ref_opt.fused_update(jax.tree_util.tree_map(jnp.asarray,
                                                         grads[2]), rs, rp)
    tp, ts = opt.fused_update(torch_canonical(grads[2]), ts, tp)
    want = torch_canonical(rp)
    for k in want:
        np.testing.assert_allclose(to_flax_layout(tp[k].numpy()),
                                   to_flax_layout(want[k].numpy()),
                                   rtol=RTOL, atol=ATOL)
    back = fused_opt_state_from_flax(rs.count, rs.mu, rs.nu, tp, layouts)
    for name in back.mu:
        np.testing.assert_allclose(ts.mu[name].numpy(),
                                   back.mu[name].numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_mixed_dtype_tree_gets_per_dtype_buffers():
    tree = {"f32": torch.randn(40), "bf16": torch.randn(24).bfloat16()}
    flat, meta = fu.flatten_by_dtype(tree)
    assert set(flat) == {"float32", "bfloat16"}
    back = fu.unflatten_by_dtype(flat, meta)
    for k in tree:
        assert torch.equal(back[k], tree[k])
    opt = fu.fused_sgd(0.1, momentum=0.9)
    st = opt.init(tree)
    assert set(st.mu) == {"float32", "bfloat16"}
    p2, _ = opt.fused_update({k: torch.ones_like(v) for k, v in
                              tree.items()}, st, tree)
    assert p2["bf16"].dtype == torch.bfloat16


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown fused optimizer"):
        fu.FusedOptimizer(kind="rmsprop")


@pytest.mark.cuda
@pytest.mark.parametrize("rule", list(RULES))
def test_kernel_matches_plain_version_on_card(rule):
    """K1 on the card against its plain version on the same inputs, at a
    ragged length; chip_smoke.py checks it at ResNet-50's size too."""
    if not torch.cuda.is_available():
        pytest.skip("K1 is CUDA C++ and runs only on an NVIDIA card "
                    "(python3 chip_smoke.py runs it there)")
    _, opt = RULES[rule]
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 1_000_003
    p = torch.randn(n, device="cuda", generator=gen)
    ours = {"p": p, "mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
    plain = {k: v.clone() for k, v in ours.items()}
    before = kernels.fused_update_launches[rule]
    for step in range(1, 4):
        g = torch.randn(n, device="cuda", generator=gen)
        s = opt._scalars(step)
        fu.flat_update_(rule, ours["p"], g, ours["mu"], ours["nu"], **s)
        args = {"sgd": (plain["p"], g),
                "momentum": (plain["p"], g, plain["mu"]),
                "adam": (plain["p"], g, plain["mu"], plain["nu"])}[rule]
        getattr(fu, f"plain_{rule}_")(*args, **s)
    torch.cuda.synchronize()
    assert kernels.fused_update_launches[rule] == before + 3
    for k in ours:
        torch.testing.assert_close(ours[k], plain[k], rtol=RTOL, atol=ATOL)
