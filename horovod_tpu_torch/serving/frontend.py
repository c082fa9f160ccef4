"""Front-end request router: the serving plane's face on the
rendezvous HTTP server — the port of ``horovod_tpu/serving/frontend.py``.

The launcher's :class:`~horovod_tpu_torch.run.http_server.RendezvousServer`
already authenticates every request (HMAC signature) and aggregates the
job's control plane; ``python -m horovod_tpu_torch.run --serve``
attaches one of these frontends to it, adding three signed routes:

* ``POST /infer`` — one inference request: JSON ``{"inputs": [...]}``
  in, ``{"id", "outputs", "latency_ms", "replica"}`` out (503 at the
  admission cap, 504 past the request timeout, 500 on a replica
  failure).  The handler thread blocks in the broker wait — the server
  is a ``ThreadingHTTPServer``, so concurrent requests ride their own
  threads.
* ``POST /serving/pull`` / ``POST /serving/result`` — the remote
  replica protocol (serving/replica.py :class:`RemoteSource`): workers
  on other hosts pull request batches and post results through the
  same signed channel.
* ``GET /serving`` — the status page: broker window stats (queue
  depth, windowed p50/p99), per-outcome counters, SLO, and the
  autoscaler's world/events when one is attached.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils import env as env_util
from ..utils.logging import get_logger
from .broker import QueueFullError, RequestBroker

log = get_logger(__name__)


class ServingFrontend:
    """Route handler attached to a RendezvousServer
    (``server.attach_serving(frontend)``); every handler returns
    ``(http_status, json_payload)`` and never raises into the HTTP
    stack."""

    def __init__(self, broker: RequestBroker, *,
                 autoscaler=None,
                 timeout_s: Optional[float] = None) -> None:
        self.broker = broker
        self.autoscaler = autoscaler
        self.timeout_s = float(
            timeout_s if timeout_s is not None
            else env_util.get_float(env_util.HVD_SERVE_TIMEOUT_SECONDS,
                                    env_util.DEFAULT_SERVE_TIMEOUT_SECONDS))
        self.slo_ms = env_util.get_float(env_util.HVD_SERVE_SLO_MS,
                                         env_util.DEFAULT_SERVE_SLO_MS)

    # -- POST /infer ---------------------------------------------------------
    def handle_infer(self, payload: dict) -> Tuple[int, dict]:
        if not isinstance(payload, dict) or "inputs" not in payload:
            return 400, {"error": "body must be a JSON object with "
                                  "an 'inputs' array"}
        try:
            inputs = np.asarray(payload["inputs"], dtype=np.float32)
        except (TypeError, ValueError) as e:
            return 400, {"error": f"undecodable inputs: {e}"}
        try:
            req = self.broker.submit(inputs)
        except QueueFullError as e:
            return 503, {"error": str(e)}
        try:
            out = self.broker.wait(req, self.timeout_s)
        except TimeoutError as e:
            return 504, {"error": str(e), "id": req.id}
        except RuntimeError as e:
            return 500, {"error": str(e), "id": req.id}
        lat = req.latency_s()
        return 200, {
            "id": req.id,
            "outputs": np.asarray(out).tolist(),
            "latency_ms": round(lat * 1000.0, 3)
            if lat is not None else None,
            "replica": req.completed_by,
        }

    # -- POST /serving/pull and /serving/result (remote replicas) ------------
    def handle_pull(self, payload: dict) -> Tuple[int, dict]:
        replica_id = str(payload.get("replica_id", ""))
        if not replica_id:
            return 400, {"error": "replica_id required"}
        max_n = int(payload.get("max_batch", 1))
        wait_s = float(payload.get("wait_ms", 0.0)) / 1000.0
        # cap the long-poll so a vanished replica's handler thread
        # cannot park forever on the server
        batch = self.broker.pull(replica_id, max_n, min(wait_s, 30.0))
        return 200, {"requests": [
            {"id": r.id, "inputs": np.asarray(r.inputs).tolist()}
            for r in batch]}

    def handle_result(self, payload: dict) -> Tuple[int, dict]:
        replica_id = str(payload.get("replica_id", ""))
        if not replica_id:
            return 400, {"error": "replica_id required"}
        accepted = 0
        for res in payload.get("results", ()):
            req_id = res.get("id")
            if req_id is None:
                continue
            if res.get("error") is not None:
                ok = self.broker.fail(int(req_id), str(res["error"]),
                                      replica_id)
            else:
                ok = self.broker.complete(
                    int(req_id),
                    np.asarray(res.get("output"), dtype=np.float32),
                    replica_id)
            accepted += 1 if ok else 0
        return 200, {"accepted": accepted}

    # -- GET /serving --------------------------------------------------------
    def report(self) -> dict:
        out = {
            "broker": self.broker.window_stats(),
            "slo_ms": self.slo_ms,
            "timeout_s": self.timeout_s,
            "autoscaler": self.autoscaler.snapshot()
            if self.autoscaler is not None else None,
        }
        return out
