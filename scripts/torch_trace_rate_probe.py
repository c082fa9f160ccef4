#!/usr/bin/env python3
"""The GPT bench's graphed rate with the trace plane off and on, in turns,
in one process on one card, with the card's SM clock and power sampled
while each run times its iterations.

    python3 scripts/torch_trace_rate_probe.py [--rounds 4] [--out FILE]

Each round runs the GPT bench at its defaults (GPT-2 small, batch 4, seq
1024, bf16, graphed) four ways: ``off`` (no trace plane), ``trace`` (as
``chip_smoke.py``'s trace_plane runs it: ``HVD_TRACE_DIR`` with a window
of calls 3-5, ``HVD_PROFILE=1`` and ``HVD_PROFILE_XLA=1`` over it, the
timeline opened), ``profile`` (only ``HVD_PROFILE=1`` over calls 3-5) and
``timeline`` (only the timeline, opened over calls 3-5), in that order and
then backwards.  Prints one JSON line a run (the iterations' seq/s, their
mean over iterations 2 and 3, which trail the window, and the median SM
clock and power while the run ran), then one line with each way's runs,
then the card's name and power limit as nvidia-smi gives them.  The trace
directories go under ``build/trace_rate_probe`` (gitignored).  Needs a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

#: the window the traced ways cover (calls), as trace_plane's
WINDOW = (3, 5)
OUT_DIR = HERE / "build" / "trace_rate_probe"
SMI_QUERY = "clocks.sm,power.draw"


#: the ways that open the timeline (the others leave it closed)
TIMELINE_WAYS = ("trace", "timeline")


def way_env(way: str, trace_dir: Path) -> dict:
    """The environment of one way; compute.json and comm.json go under
    ``trace_dir``."""
    start, end = (str(n) for n in WINDOW)
    trace = {"HVD_TRACE_DIR": str(trace_dir), "HVD_TRACE_START_STEP": start,
             "HVD_TRACE_END_STEP": end}
    profile = {"HVD_TRACE_DIR": str(trace_dir), "HVD_PROFILE": "1",
               "HVD_PROFILE_START_STEP": start, "HVD_PROFILE_END_STEP": end}
    return {"off": {}, "trace": {**trace, "HVD_PROFILE": "1",
                                 "HVD_PROFILE_XLA": "1"},
            "profile": profile, "timeline": trace}[way]


def sampled(fn):
    """``fn()`` with nvidia-smi sampling the card every 100 ms meanwhile:
    ``(result, median SM MHz, median W)``."""
    smi = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        result = fn()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = [[float(v) for v in ln.split(",")] for ln in out.splitlines()
            if ln.strip() and "N/A" not in ln]
    if not rows:
        return result, None, None
    return (result, statistics.median(r[0] for r in rows),
            statistics.median(r[1] for r in rows))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on an NVIDIA card")
    from horovod_tpu_torch import core
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb
    from horovod_tpu_torch.timeline.timeline import timeline

    core.init(backend="cpu:gloo,cuda:nccl")
    ways = ("off", "trace", "profile", "timeline")
    runs = {way: [] for way in ways}
    lines = []
    for r in range(args.rounds):
        for way in ways if r % 2 == 0 else ways[::-1]:
            trace_dir = OUT_DIR / f"{way}{r}"
            saved = {k: os.environ.get(k) for k in way_env(way, trace_dir)}
            os.environ.update(way_env(way, trace_dir))
            try:
                if way in TIMELINE_WAYS:
                    timeline.initialize()
                t0 = time.perf_counter()
                res, mhz, watts = sampled(lambda: gb.run(gb.parse_args([])))
                wall = time.perf_counter() - t0
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            rates = res["rates"]
            line = {"round": r, "way": way, "rates": rates,
                    "outside_window": statistics.mean(rates[1:]),
                    "sm_mhz": mhz, "power_w": watts, "wall_s": wall}
            runs[way].append(line["outside_window"])
            lines.append(line)
            print(json.dumps(line), flush=True)
    summary = {"outside_window_by_way": runs,
               "median_by_way": {w: statistics.median(v)
                                 for w, v in runs.items()}}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    core.shutdown()
    if args.out is not None:
        args.out.write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
