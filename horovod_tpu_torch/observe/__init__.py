"""Observability of the control plane and the online anomaly watchdog:
the port of ``horovod_tpu/observe/``.

The flight recorder (``events.py``); detectors (detectors.py) over the
always-on telemetry time-series; the watchdog (watchdog.py) that runs
them next to the launcher's rendezvous server, publishes alerts to the
``alerts`` KV scope (``GET /alerts``, ``hvd_alerts_total``), and closes
the loop: a confirmed step-time or straggler alert auto-arms a
trace+profile window — armed rank-consistently via a KV-broadcast start
step (autoarm.py) — so the alert ships with attribution instead of a
bare number; the invariant monitors (invariants.py) and the
hand-computed fixtures the tests and ``python -m
horovod_tpu_torch.observe.watch --check`` pin (fixtures.py).
"""

from __future__ import annotations

from .detectors import (  # noqa: F401
    comm_beta_drift,
    ewma_mad_regression,
    mfu_drop,
    slo_burn_rate,
    straggler_drift,
    straggler_from_verdicts,
)
from .watchdog import Watchdog  # noqa: F401
