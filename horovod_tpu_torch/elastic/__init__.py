"""The failure-domain runtime: the port of ``horovod_tpu/elastic/``.

* **join** (join.py) — uneven-data participation, the reference's
  ``hvd.join()`` contract;
* **coordinated abort** (abort.py) and **heartbeat leases**
  (heartbeat.py) — one job-wide abort flag on the launcher's rendezvous
  server, raised as :class:`HorovodAbortError` at the train-step and
  dispatch seams, and per-rank leases with a ``GET /health`` view.

Elastic state, membership, the peer state plane, the fault harness and
the elastic driver are ROADMAP item 13.
"""

from .abort import HorovodAbortError, abort  # noqa: F401
