"""Rendezvous servers for the tests of the port's KV plane: the port's
``RendezvousServer`` and the reference's, started side by side in the
test process on ports they bind themselves, and a scripted sequence of
signed requests that both answer.

``serving(kind)`` starts one (``"port"`` or ``"reference"``); ``kv_env``
points a process's pushes at it (``HVD_METRICS_KV_*``); ``raw`` sends
one signed request and returns ``(status, reply bytes)``.
"""

from __future__ import annotations

import contextlib
import http.client
import json

from horovod_tpu.run import http_client as ref_client
from horovod_tpu.run import http_server as ref_server
from horovod_tpu.run import journal as ref_journal
from horovod_tpu.run import relay as ref_relay
from horovod_tpu.run import store as ref_store
from horovod_tpu_torch.run import http_client as port_client
from horovod_tpu_torch.run import http_server as port_server
from horovod_tpu_torch.run import journal as port_journal
from horovod_tpu_torch.run import relay as port_relay
from horovod_tpu_torch.run import store as port_store

SECRET = bytes(range(16))

#: each side's modules, by side
SIDES = {
    "port": {"server": port_server, "client": port_client,
             "journal": port_journal, "relay": port_relay,
             "store": port_store},
    "reference": {"server": ref_server, "client": ref_client,
                  "journal": ref_journal, "relay": ref_relay,
                  "store": ref_store},
}

#: (client side, server side): the port's client against the
#: reference's server, and the reference's client against the port's
DIRECTIONS = [("port", "reference"), ("reference", "port")]


@contextlib.contextmanager
def serving(kind: str, secret: bytes = SECRET, **kw):
    srv = SIDES[kind]["server"].RendezvousServer(secret=secret, **kw)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


def kv_env(monkeypatch, srv, secret: bytes = SECRET) -> None:
    """This process's pushes go to ``srv``."""
    monkeypatch.setenv("HVD_METRICS_KV_ADDR", "127.0.0.1")
    monkeypatch.setenv("HVD_METRICS_KV_PORT", str(srv.port))
    monkeypatch.setenv("HVD_METRICS_SECRET", secret.hex())


def raw(port: int, method: str, path: str, body: bytes = b"",
        secret: bytes = SECRET, sign: bool = True):
    """One request, signed as both clients sign (``sign`` of the port's
    server module, held byte-equal to the reference's by the tests)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    headers = {"Content-Length": str(len(body))}
    if sign:
        headers[port_server.SECRET_HEADER] = port_server.sign(
            secret, path.split("?")[0], body)
    try:
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def snapshot(value: float, extra: bool = False) -> dict:
    """A registry snapshot in the registry's format, at a fixed time: a
    counter and a gauge (and, with ``extra``, a labelled counter)."""
    fams = {
        "hvd_steps_total": {"type": "counter", "help": "Train steps.",
                            "samples": [{"labels": {}, "value": value}]},
        "hvd_train_loss": {"type": "gauge", "help": "Last loss.",
                           "samples": [{"labels": {}, "value": value / 7}]},
    }
    if extra:
        fams["hvd_allreduce_calls_total"] = {
            "type": "counter", "help": "Calls.",
            "samples": [{"labels": {"op": "allreduce"}, "value": 3.0}]}
    return {"metrics": fams, "ts": 1000.0 + value}


def anatomy(scale: float) -> dict:
    """A compute anatomy of the profiler's schema (two segments)."""
    segs = {
        name: {"count": 2, "device_us": us * scale,
               "per_step_us": us * scale / 2, "fraction": frac,
               "flops": 1e9, "bytes": 1e6, "verdict": "compute-bound"}
        for name, us, frac in (("forward", 300.0, 0.3),
                               ("backward", 700.0, 0.7))}
    return {"steps": 2, "wall_us": 1000.0 * scale, "segments": segs,
            "host_gap": {"per_step_us": 5.0, "fraction": 0.01, "spans": 1},
            "top_segment": "backward", "verdict": "compute-bound",
            "mfu": 0.4, "peak_flops": 1e15}


def json_body(obj) -> bytes:
    return json.dumps(obj).encode()


#: reply fields that differ between two servers by nature: the
#: incarnation id, lease ages, the server's clock and the time a delta
#: merge stamps on the document it merged into
VOLATILE = ("server_id", "age_seconds", "server_us", "ts")


def normalized(body: bytes):
    """A reply with its :data:`VOLATILE` fields blanked (JSON), or the
    bytes themselves."""
    try:
        obj = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return body

    def blank(o):
        if isinstance(o, dict):
            return {k: "<volatile>" if k in VOLATILE else blank(v)
                    for k, v in o.items()}
        if isinstance(o, list):
            return [blank(v) for v in o]
        return o

    return blank(obj)


def launcher_free(prom: bytes) -> list:
    """The lines of a ``GET /metrics`` page that come from the pushed
    ranks (each server also renders its own process's registry under
    ``rank="launcher"``, which differs between the two packages)."""
    return [ln for ln in prom.decode().splitlines()
            if 'rank="' in ln and 'rank="launcher"' not in ln]
