#!/usr/bin/env python3
"""Does the watched job's own polling raise the watchdog's false alerts?

Runs ``scripts/torch_serve_tasks.py watch`` under ``python -m
horovod_tpu_torch.run -np 1`` as ``chip_smoke.py``'s phase ``serving``
(e) does — the headline ResNet-50 cell, the watchdog on, the step seam
slowed 30 ms from call 41 — ``--reps`` times each with the task polling
the launcher from step 1 and from step 40, in turns.  For each run it
prints one JSON line: where the alert fired, the cadence the launcher
held at the steps right after a poll before the slowdown, less the
median of the clean cadence, and the ticks on the clean cadence that
could have fired (``early_fires``).  Needs the card:

    python3 scripts/torch_watch_poll_probe.py --reps 3
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_serve_tasks as tasks  # noqa: E402

SLOW_FROM, SLOW_MS, STEPS, POLL_EVERY = 40, 30, 300, 10


def one_run(poll_from: int) -> dict:
    spec = ";".join(f"rank=0:step={s}:kind=slow={SLOW_MS}ms"
                    for s in range(SLOW_FROM, STEPS))
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    env.update({"HVD_WATCH_INTERVAL_SECONDS": "0.5",
                "HVD_TIMESERIES_FLUSH_SECONDS": "0.5",
                "HVD_FAULT_SPEC": spec, "TMPDIR": tempfile.mkdtemp()})
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
         sys.executable, str(ROOT / "scripts" / "torch_serve_tasks.py"),
         "watch", "--steps", str(STEPS), "--poll-from", str(poll_from)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    watched = {}
    for line in proc.stdout.splitlines():
        body = line.partition("<stdout>: ")[2]
        if body.startswith("{") and '"watched"' in body:
            watched = json.loads(body)
    cadence = watched.get("cadence_ms") or []
    clean = {st: v for st, v in cadence if st <= SLOW_FROM}
    med = statistics.median(clean.values()) if clean else None
    return {"poll_from": poll_from, "rc": proc.returncode,
            "fired_step": ((watched.get("alert") or {}).get("evidence")
                           or {}).get("fired_step"),
            "clean_median_ms": med,
            "clean_max_ms": max(clean.values()) if clean else None,
            "after_poll_excess_ms": {
                st + 1: round(clean[st + 1] - med, 3)
                for st in range(POLL_EVERY, SLOW_FROM, POLL_EVERY)
                if st + 1 in clean},
            "early_fires": tasks.early_fires(
                [[st, v / 1e3] for st, v in cadence], SLOW_FROM)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()
    for _ in range(args.reps):
        for poll_from in (1, SLOW_FROM):
            print(json.dumps(one_run(poll_from)), flush=True)


if __name__ == "__main__":
    main()
