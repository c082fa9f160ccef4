"""The failure-domain runtime: the port of ``horovod_tpu/elastic/``.

* **join** (join.py) — uneven-data participation, the reference's
  ``hvd.join()`` contract;
* **failure-domain runtime** (abort.py, heartbeat.py, state.py,
  faults.py) — heartbeat leases with a ``GET /health`` view, one
  job-wide abort flag raised as :class:`HorovodAbortError` at the
  train-step and dispatch seams, :class:`ElasticState` auto-resume under
  ``--restarts``, and the ``HVD_FAULT_SPEC`` fault-injection harness that
  tests all of it.  The **peer state plane** (peerstate.py,
  ``HVD_SNAPSHOT=1``) layers async K-peer-replicated snapshots over the
  storage checkpoints: a grouped device copy on the step path, restore
  from peers, the storage tier demoted to a slow durable backstop.
* **elastic membership** (membership.py worker side, driver.py launcher
  side; ``--elastic``) — shrink/grow worlds through committed membership
  epochs: survivors rebuild in process (``core.reinit()``, a fresh
  ``TCPStore`` and ``ControllerServer`` each epoch), ranks are
  re-assigned densely, state re-syncs via rank-0 in-memory broadcast, and
  spare hosts rejoin at epoch boundaries without a relaunch.
  :func:`run` is the ``@hvd.elastic.run`` analog.
"""

from .abort import HorovodAbortError, abort  # noqa: F401
from .state import ElasticState  # noqa: F401
from .membership import (  # noqa: F401
    RemovedFromWorldError,
    join_world,
    run,
)
from . import driver, faults, heartbeat, membership, peerstate  # noqa: F401
