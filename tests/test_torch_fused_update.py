"""horovod_tpu_torch.optim.fused_update against the reference.

On the CPU the port's fused path runs K1's plain PyTorch version; it is
held against the reference's Pallas kernel (interpret mode, as
tests/test_fused_update.py runs it) and against ``numpy_fused_update``,
at the reference's own pinned tolerance rtol 2e-6 / atol 1e-7 (the
expressions are order-identical; only float32 rounding of the bias
corrections' power, and the oracle's division where the kernel
multiplies, can differ).  The per-leaf path equals the fused one bit for
bit, as the reference pins within itself.  K1 itself runs only on the
card: its tests are marked ``cuda`` and skip here.

bfloat16 parameter groups.  The port rounds every operation of a bf16
group to bf16, where PyTorch rounds it (K1 does the same on the card).
Against the reference on a mixed float32 + bf16 tree, a bf16 leaf is
held to one bf16 ulp of the reference's value (``_bf16_ulps``): XLA on
the CPU may keep a fused bf16 chain in float32 where PyTorch rounds per
operation, which moves a result by at most one rounding.  Measured: no
bf16 element differed at all, in SGD, momentum or Adam, jnp or Pallas
path, over every step.  The reference's own Adam does not keep a bf16
group bf16: its ``1.0 - b1`` is a numpy float32 scalar that promotes the
group to float32 in the jnp path (the new parameters and moments come
back float32, so its state's keys no longer match a second step) and
makes its Pallas kernel raise on the bf16 output.  So Adam's bf16 group
is held to the reference's FusedOptimizer for one step (jnp path), and
over several steps to the reference's own Adam math and Pallas kernel
given the group's scalars as bf16-exact Python floats, which keep the
group in bf16 as the port does.
"""

from functools import partial

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


# ---------------------------------------------------------------------------
# bfloat16 parameter groups
# ---------------------------------------------------------------------------
#: a float32 group (a, d) and a bf16 group (b, c), ragged as SHAPES
MIXED = {"a": ((7, 5), np.float32), "b": ((300,), "bf16"),
         "c": ((1001,), "bf16"), "d": ((13, 17), np.float32)}
#: b2 whose bf16 rounding is below 1 (bf16(0.999) is 1.0, which makes
#: 1 - b2 zero in both frameworks and nu stay 0)
BF16_ADAM = {"learning_rate": 1e-3, "b1": 0.9, "b2": 0.99}
#: Adam's b2 on a bf16 group: 0.99, whose moments move, and the default
#: 0.999, which rounds to 1.0: nu stays 0 and each step is lr * mu_hat /
#: eps, in the reference as in the port (ROADMAP section 3)
ADAM_B2 = pytest.mark.parametrize("b2", [0.99, 0.999],
                                  ids=["b2_0.99", "default_b2"])


def _assert_frozen_nu(nu_port, nu_ref, b2) -> None:
    """At a b2 that rounds to 1.0 in bf16, nu is exactly 0 on both
    sides."""
    if torch.tensor(b2, dtype=torch.bfloat16).item() == 1.0:
        assert not nu_port.any() and not np.asarray(nu_ref).any()


def _mixed(rng):
    return {k: rng.normal(size=shape).astype(np.float32)
            for k, (shape, _) in MIXED.items()}


def _jmixed(tree):
    return {k: jnp.asarray(v).astype(
        jnp.bfloat16 if MIXED[k][1] == "bf16" else jnp.float32)
        for k, v in tree.items()}


def _tmixed(tree):
    return {k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if MIXED[k][1] == "bf16" else torch.float32)
        for k, v in tree.items()}


def _bf16_ulps(got, want) -> float:
    """The largest difference in units of one bf16 ulp of ``want``."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return float(np.max(np.abs(got - want) / 2.0 ** (exp - 7)))


def _assert_group(got: torch.Tensor, want, bf16: bool) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if bf16:
        assert got.dtype == torch.bfloat16
        assert _bf16_ulps(got.float().numpy(), want) <= 1.0
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


#: the port's bf16 Adam step against the reference's float32-promoted
#: one: one bf16 ulp of the new value (the port's last rounding) plus
#: 2^-5 of the update, room for four one-ulp (2^-8) roundings in the
#: chain of seven bf16 operations that makes the update (ten seeds read
#: up to 0.009 of the update beyond the ulp)
ADAM_PROMOTED_UPDATE_RTOL = 2.0 ** -5


@pytest.mark.parametrize("pallas", ["0", "1"], ids=["jnp", "pallas"])
@pytest.mark.parametrize("rule", ["sgd", "momentum"])
def test_bf16_groups_match_reference_fused_update(rule, pallas,
                                                  monkeypatch):
    """FusedOptimizer.fused_update on a mixed float32 + bf16 tree, four
    steps, against the reference's FusedOptimizer: its jnp path and its
    Pallas kernel in interpret mode."""
    ref_opt, opt = RULES[rule]
    rng = np.random.default_rng(77)
    params, grads = _mixed(rng), [_mixed(rng) for _ in range(4)]
    monkeypatch.setenv("HVD_FUSED_UPDATE_PALLAS", pallas)
    step = jax.jit(lambda g, s, p: ref_opt.fused_update(g, s, p))
    rp = _jmixed(params)
    rs = ref_opt.init(rp)
    tp = _tmixed(params)
    ts = opt.init(tp)
    assert set(ts.mu) == set(rs.mu)
    for g in grads:
        rp, rs = step(_jmixed(g), rs, rp)
        tp, ts = opt.fused_update(_tmixed(g), ts, tp)
        for k, (_, kind) in MIXED.items():
            _assert_group(tp[k], rp[k], kind == "bf16")
        for name in rs.mu:
            _assert_group(ts.mu[name], rs.mu[name], name == "bfloat16")


@ADAM_B2
def test_bf16_adam_group_first_step_matches_reference_fused_update(
        monkeypatch, b2):
    """Adam on a mixed tree, one step, against the reference's
    FusedOptimizer (jnp path), which hands its bf16 group back in
    float32: the port's bf16 values are within one bf16 ulp of it plus
    ADAM_PROMOTED_UPDATE_RTOL of the update."""
    monkeypatch.setenv("HVD_FUSED_UPDATE_PALLAS", "0")
    hyper = {**BF16_ADAM, "b2": b2}
    ref_opt, opt = ref_fu.fused_adam(**hyper), fu.fused_adam(**hyper)
    rng = np.random.default_rng(78)
    params, g = _mixed(rng), _mixed(rng)
    rp, rs = ref_opt.fused_update(_jmixed(g), ref_opt.init(_jmixed(params)),
                                  _jmixed(params))
    tp = _tmixed(params)
    before = {k: v.float().numpy() for k, v in tp.items()}
    tp, ts = opt.fused_update(_tmixed(g), opt.init(tp), tp)
    assert rp["b"].dtype == jnp.float32     # the reference's promotion
    for k, (_, kind) in MIXED.items():
        if kind != "bf16":
            _assert_group(tp[k], rp[k], False)
            continue
        assert tp[k].dtype == torch.bfloat16
        got, want = tp[k].float().numpy(), np.asarray(rp[k])
        exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
        limit = 2.0 ** (exp - 7) + ADAM_PROMOTED_UPDATE_RTOL * np.abs(
            want - before[k])
        assert np.all(np.abs(got - want) <= limit), k
    for name in rs.mu:
        _assert_group(ts.mu[name], rs.mu[name], name == "bfloat16")
        _assert_group(ts.nu[name], rs.nu[name], name == "bfloat16")
    _assert_frozen_nu(ts.nu["bfloat16"], rs.nu["bfloat16"], b2)


@ADAM_B2
@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_bf16_adam_group_matches_reference_kernel(pallas, b2):
    """Adam on one bf16 group, five steps, against the reference's Adam
    math (``_adam_update`` under jit) and its Pallas kernel
    (``_adam_kernel`` in interpret mode), given the port's bf16 scalars
    as Python floats so that the reference keeps the group bf16."""
    opt = fu.fused_adam(**{**BF16_ADAM, "b2": b2})
    rng = np.random.default_rng(79)
    n = 1301
    p0 = rng.normal(size=n).astype(np.float32)
    tp = {"w": torch.from_numpy(p0).bfloat16()}
    ts = opt.init(tp)
    rp = jnp.asarray(p0).astype(jnp.bfloat16)
    rmu = jnp.zeros(n, jnp.bfloat16)
    rnu = jnp.zeros(n, jnp.bfloat16)
    for count in range(1, 6):
        g = rng.normal(size=n).astype(np.float32)
        s = opt._scalars(count, torch.bfloat16)
        rg = jnp.asarray(g).astype(jnp.bfloat16)
        bc = jnp.asarray([s["inv_bc1"], s["inv_bc2"]], jnp.bfloat16)
        if pallas:
            row = jnp.zeros((1, 128), jnp.bfloat16).at[0, :2].set(bc)
            rp, rmu, rnu = ref_fu._pallas_elementwise(
                partial(ref_fu._adam_kernel, s["lr"], s["b1"], s["b2"],
                        s["eps"]), [rp, rg, rmu, rnu], 3, scalars=[row])
        else:
            u, rmu, rnu = jax.jit(partial(
                ref_fu._adam_update, lr=s["lr"], b1=s["b1"], b2=s["b2"],
                eps=s["eps"]))(rg, rmu, rnu, inv_bc1=bc[0], inv_bc2=bc[1])
            rp = rp + u
        tp, ts = opt.fused_update({"w": torch.from_numpy(g).bfloat16()},
                                  ts, tp)
        assert rp.dtype == rmu.dtype == rnu.dtype == jnp.bfloat16
        _assert_group(tp["w"], rp, True)
        _assert_group(ts.mu["bfloat16"], rmu, True)
        _assert_group(ts.nu["bfloat16"], rnu, True)
        _assert_frozen_nu(ts.nu["bfloat16"], rnu, b2)


@pytest.mark.parametrize("dtypes,ok", [
    ((torch.float32,) * 3, True), ((torch.bfloat16,) * 3, True),
    ((torch.bfloat16, torch.float32, torch.bfloat16), False),
    ((torch.float16,) * 3, False)], ids=["f32", "bf16", "mixed", "f16"])
def test_k1_takes_one_float32_or_bf16_group(monkeypatch, dtypes, ok):
    monkeypatch.setattr(kernels, "_check_on_card", lambda *a: None)
    bufs = [torch.empty(10, dtype=d, device="meta") for d in dtypes]
    if ok:
        kernels._check(bufs)
    else:
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kernels._check(bufs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", list(RULES))
def test_k1_counts_launches_by_rule_and_group_type(monkeypatch, rule,
                                                  dtype):
    """A K1 launch is counted under its rule and its group's type, so a
    run can tell bf16 launches from float32 ones (meta tensors stand in
    for card tensors; nothing is launched)."""
    seen = []
    monkeypatch.setattr(kernels, "_check_on_card", lambda *a: None)
    monkeypatch.setattr(kernels, "_launch",
                        lambda fn, counts, key, dev, *args: seen.append(
                            (fn, counts is kernels.fused_update_launches,
                             key, args[-1])))
    p = torch.empty(10, dtype=dtype, device="meta")
    kernels.launch_fused_update(rule, p, torch.empty_like(p),
                                torch.empty_like(p), torch.empty_like(p),
                                lr=0.1)
    name = str(dtype).split(".")[-1]
    assert seen == [(f"hvd_{rule}", True, f"{rule}.{name}",
                     kernels._DTYPES[dtype])]
    assert set(kernels.fused_update_launches) == {
        f"{r}.{d}" for r in RULES for d in kernels.K1_DTYPES}
    assert kernels.launch_totals({f"{rule}.float32": 2,
                                  f"{rule}.bfloat16": 3}) == {rule: 5}


@pytest.mark.cuda
@pytest.mark.parametrize("rule", list(RULES))
def test_bf16_kernel_is_bit_equal_to_plain_version_on_card(rule):
    """K1 on a bf16 group on the card against its plain version on the
    same inputs, bit for bit, at a ragged length and off 16-byte
    alignment (the scalar loop)."""
    if not torch.cuda.is_available():
        pytest.skip("K1 is CUDA C++ and runs only on an NVIDIA card "
                    "(python3 chip_smoke.py runs it there)")
    _, opt = RULES[rule]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, off in ((1_000_003, 0), (4099, 1)):
        buf = torch.randn(n + off, device="cuda", generator=gen).bfloat16()
        p = buf[off:]
        ours = {"p": p, "mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
        plain = {k: v.clone() for k, v in ours.items()}
        before = dict(kernels.fused_update_launches)
        for step in range(1, 4):
            g = torch.randn(n, device="cuda", generator=gen).bfloat16()
            s = opt._scalars(step, torch.bfloat16)
            fu.flat_update_(rule, ours["p"], g, ours["mu"], ours["nu"], **s)
            args = {"sgd": (plain["p"], g),
                    "momentum": (plain["p"], g, plain["mu"]),
                    "adam": (plain["p"], g, plain["mu"], plain["nu"])}[rule]
            getattr(fu, f"plain_{rule}_")(*args, **s)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in
                kernels.fused_update_launches.items() if v != before[k]} == \
            {f"{rule}.bfloat16": 3}
        for k in ours:
            assert torch.equal(ours[k], plain[k]), (rule, n, k)


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
    before = kernels.fused_update_launches[f"{rule}.float32"]
    for step in range(1, 4):
        g = torch.randn(n, device="cuda", generator=gen)
        s = opt._scalars(step)
        fu.flat_update_(rule, ours["p"], g, ours["mu"], ours["nu"], **s)
        args = {"sgd": (plain["p"], g),
                "momentum": (plain["p"], g, plain["mu"]),
                "adam": (plain["p"], g, plain["mu"], plain["nu"])}[rule]
        getattr(fu, f"plain_{rule}_")(*args, **s)
    torch.cuda.synchronize()
    assert kernels.fused_update_launches[f"{rule}.float32"] == before + 3
    for k in ours:
        torch.testing.assert_close(ours[k], plain[k], rtol=RTOL, atol=ATOL)
