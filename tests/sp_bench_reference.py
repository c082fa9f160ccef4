"""Shared by ``tests/test_torch_sp_bench_{gpt,bert}.py``: the GPT and
BERT benches' ``--seq-parallel ring|ulysses`` against the reference
benches' sequence-parallel path.

For one bench, a 2-rank gloo job (``tests/torch_dist_worker.py``, task
``sp_bench_<bench>``) runs the port's bench at tiny size, float32, 2
steps (a warm-up and one timed), from the reference's initial weights
(and, for BERT, its MLM head): ring and Ulysses attention in torch ops
and ring on the flash path.  The reference runs its bench on a 2-device
CPU mesh with ``--attn xla`` (its lax ring and softmax Ulysses; the
flash forms are held to those by tests/test_torch_ring_attention.py),
once for each ``--seq-parallel`` mode, shared by that mode's cases.  The
final losses agree to 1e-5 (float32; GPT's fused Adam computes optax's
Adam expression for expression, BERT's AdamW is optax's).  Each bench
has a file of its own so that the two run side by side under xdist.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import horovod_tpu as hvd
from horovod_tpu.models import bert as ref_bert
from horovod_tpu.models import gpt as ref_gpt
from horovod_tpu_torch.convert import flatten_flax
from torch_dist_worker import SP_BENCH_ARGV, SP_BENCH_RUNS, launch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples import bert_synthetic_benchmark as ref_bb  # noqa: E402
from examples import gpt_synthetic_benchmark as ref_gb  # noqa: E402

WORLD = 2
SEQ = int(SP_BENCH_ARGV[SP_BENCH_ARGV.index("--seq-len") + 1])
RTOL = 1e-5


def runs(bench: str):
    """``bench``'s (sp, attn) cases of SP_BENCH_RUNS."""
    return [(sp, attn) for b, sp, attn in SP_BENCH_RUNS if b == bench]


def _initial_values(bench: str) -> dict:
    """The reference bench's own initial values: its parameters (its
    init call) and, for BERT, its fixed MLM head."""
    with jax.default_device(jax.devices("cpu")[0]):
        if bench == "gpt":
            model = ref_gpt.gpt_tiny(dtype=jnp.float32,
                                     max_len=max(SEQ, 1024))
            params = model.init(jax.random.PRNGKey(0),
                                jnp.zeros((2, SEQ), jnp.int32))["params"]
        else:
            model = ref_bert.bert_tiny(dtype=jnp.float32,
                                       max_len=max(SEQ, 512))
            params = model.init(jax.random.PRNGKey(0),
                                np.zeros((1, SEQ), np.int32))["params"]
            head = jax.random.normal(jax.random.PRNGKey(1),
                                     (model.hidden_dim, model.vocab_size),
                                     jnp.float32) * 0.02
    out = {f"{bench}:{k}": v for k, v in flatten_flax(params).items()}
    if bench == "bert":
        out["head"] = np.asarray(head)
    return out


def port_losses(bench: str, workdir: Path) -> dict:
    """The port's final losses, ``"<bench>/<sp>/<attn>"`` keyed, after
    checking that both ranks hold the same (averaged) loss."""
    np.savez(workdir / "inputs.npz", **_initial_values(bench))
    task = f"sp_bench_{bench}"
    launch(task, WORLD, workdir, timeout=120)
    per_rank = [dict(np.load(workdir / f"{task}.{r}.npz"))
                for r in range(WORLD)]
    for name in per_rank[0]:
        assert float(per_rank[0][name]) == float(per_rank[1][name]), name
    return {k: float(v) for k, v in per_rank[0].items()}


def reference_losses(bench: str) -> dict:
    """The reference bench's sequence-parallel runs, ``--attn xla``, on a
    2-device mesh: the final loss of each ``--seq-parallel`` mode."""
    mod = ref_gb if bench == "gpt" else ref_bb
    argv = [a for a in SP_BENCH_ARGV if a not in ("--device", "cpu")]
    hvd.shutdown()
    hvd.init(devices=jax.devices("cpu")[:WORLD])
    out = {}
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            for sp in sorted({sp for sp, _ in runs(bench)}):
                res = mod.run(mod.parse_args(argv + [
                    "--seq-parallel", sp, "--attn", "xla"]))
                out[sp] = res["final_loss"]
    finally:
        hvd.shutdown()
    return out


def check(port: dict, reference: dict, bench: str, sp: str, attn: str):
    got = port[f"{bench}/{sp}/{attn}"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, reference[sp], rtol=RTOL)
