#!/usr/bin/env python3
"""Two checkouts of the PyTorch / CUDA port, side by side on one card:
the rates the trace plane could move.

    python3 scripts/torch_trace_ab.py OTHER_ROOT [--rounds 2]

``OTHER_ROOT`` is another checkout of the repository (an earlier commit,
say); this script's own checkout is the second, run as it is and with
``HVD_METRICS=0`` (its metrics registry off).  Each round runs, in a
fresh process from each checkout's root, in the order other, this, this
with the registry off, then the same backwards: the GPT bench at its defaults (GPT-2 small, batch 4, seq
1024, bf16, graphed) and its ``step.eager`` rate, and the PyTorch bench
at its defaults (ResNet-50, batch 32, eager, through
``horovod_tpu_torch.torch.DistributedOptimizer``).  Each process builds
its checkout's kernels under that checkout.  Prints one JSON line a run,
then one with the medians per run kind, then the card's name and power
limit as nvidia-smi gives them.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

#: what one process runs, from a checkout's root
BENCH_CODE = r"""
import json, torch
from horovod_tpu_torch import core
from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb
from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as pb
if not torch.cuda.is_available():
    raise SystemExit("no CUDA device")
out = {"gpt_seq_sec": gb.run(gb.parse_args([]))["seq_sec_per_chip"],
       "gpt_eager_seq_sec": gb.run(gb.parse_args([]),
                                   eager=True)["seq_sec_per_chip"]}
torch.backends.cudnn.benchmark = False
out["frontend_img_sec"] = pb.run(pb.parse_args([]))["img_sec_per_proc"]
core.shutdown()
print("RESULT " + json.dumps(out), flush=True)
"""


def run_one(root: Path, env: dict) -> dict:
    proc = subprocess.run([sys.executable, "-c", BENCH_CODE], cwd=root,
                          env={**os.environ, **env}, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"{root}: exit {proc.returncode}\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of the three kinds, forwards then back")
    args = ap.parse_args()
    kinds = {"other": (args.other.resolve(), {}), "this": (HERE, {}),
             "this_metrics_off": (HERE, {"HVD_METRICS": "0"})}
    order = list(kinds) + list(kinds)[::-1]
    runs = {name: [] for name in kinds}
    for _ in range(args.rounds):
        for name in order:
            res = run_one(*kinds[name])
            runs[name].append(res)
            print(json.dumps({"run": name, **res}), flush=True)
    print(json.dumps({"medians": {
        name: {key: statistics.median(r[key] for r in rs)
               for key in rs[0]} for name, rs in runs.items()}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
