"""The port's KV plane (``horovod_tpu_torch/run/{store,http_server,
http_client,journal,relay}.py``) held to the reference's, on the wire in
both directions.

* ``sign`` and the sharded store give the reference's signatures and
  per-scope versions.
* One scripted sequence of signed requests — KV puts and reads,
  ``PUT /batch``, ``GET /scope/<name>?since=V``, metrics and time-series
  deltas (merged, and refused with 409 on a stale base), leases and
  ``GET /health``, ``/clock``, ``/profile``, ``/autotune``, ``/events``,
  the fenced ``/membership/epoch`` (409), the abort verdict in a lease's
  reply, ``/serving`` (404) and ``POST /infer`` (503), the reports — gets
  the same status and reply from the port's server as from the
  reference's, but for the incarnation id, lease ages and the server's
  clock (``torch_rdv.VOLATILE``); ``GET /metrics`` renders the pushed
  ranks' lines identically.
* Each package's client against the other's server: the KV calls, the
  scope cursor with its resync, the report getters, the epoch fence, and
  the metrics and time-series pushers' delta protocol.
* A journal written by either server replays, through either package's
  ``replay``, to the store the server held; a relay of either package
  batches its host's PUTs upstream into the other's server.
"""

import json
import urllib.error

import pytest

from torch_rdv import (
    DIRECTIONS, SECRET, SIDES, anatomy, json_body, launcher_free,
    normalized, raw, serving, snapshot,
)


def test_sign_is_the_references():
    for path, body in (("/metrics/0", b""), ("/batch", b'{"entries": []}'),
                       ("/health/12", bytes(range(256)))):
        assert SIDES["port"]["server"].sign(SECRET, path, body) == \
            SIDES["reference"]["server"].sign(SECRET, path, body)
    assert SIDES["port"]["server"].SECRET_HEADER == \
        SIDES["reference"]["server"].SECRET_HEADER


def test_store_matches_the_reference():
    stores = [SIDES[k]["store"].ShardedKVStore(shards=4)
              for k in ("port", "reference")]
    for st in stores:
        st.put("/metrics/0", b"a")
        st.put("/metrics/1", b"b")
        st.put("/health/0", b"c")
        st.delete_matching("/metrics/1")
        st.put("/metrics/2", b"d")
    got, want = stores
    assert got.items() == want.items()
    for since in (None, 0, 1, 3):
        assert got.scope_since("metrics", since) == \
            want.scope_since("metrics", since)
    got.clear_scope("metrics")
    want.clear_scope("metrics")
    assert got.scope_since("metrics", 2) == want.scope_since("metrics", 2)


def _script(port: int) -> list:
    """The scripted sequence against the server at ``port``: a list of
    ``(method, path, status, reply)``."""
    out = []

    def go(method, path, body=b"", sign=True):
        status, reply = raw(port, method, path, body, sign=sign)
        out.append((method, path, status, reply))
        return status, reply

    go("PUT", "/job/fn", b"\x00pickled")
    go("GET", "/job/fn")
    go("GET", "/job/missing")
    go("GET", "/job/fn", sign=False)                       # 401
    _, reply = go("PUT", "/metrics/0", json_body(snapshot(1.0)))
    sid = json.loads(reply)["server_id"]
    go("PUT", "/metrics/0", json_body({                    # merged delta
        "__delta__": True, "base_id": sid, "ts": 1500.0,
        "metrics": {"hvd_steps_total":
                    snapshot(2.0)["metrics"]["hvd_steps_total"]},
        "removed": ["hvd_train_loss"]}))
    go("PUT", "/metrics/1", json_body({                    # 409: resync
        "__delta__": True, "base_id": "stale", "metrics": {}}))
    go("PUT", "/metrics/1", json_body(snapshot(5.0, extra=True)))
    go("GET", "/scope/metrics?since=0")
    go("GET", "/scope/metrics?since=1")
    go("PUT", "/timeseries/0", json_body(
        {"series": {"step_seconds": {"samples": [[1, 0.5]], "seq": 1,
                                     "last_step": 1}}}))
    go("PUT", "/timeseries/0", json_body({
        "__tsdelta__": True, "base_id": sid,
        "series": {"step_seconds": {"samples": [[2, 0.25]], "seq": 2}}}))
    go("PUT", "/timeseries/1", json_body({
        "__tsdelta__": True, "base_id": "stale", "series": {}}))
    go("GET", "/timeseries")
    go("PUT", "/batch", json_body({"entries": [
        {"p": "/sanitizer/world.0.1.0", "v": "e30="},
        {"p": "/health/3", "v": "eyJyYW5rIjogM30="},
        {"p": "not-a-path", "v": "e30="}]}))
    go("PUT", "/health/0", json_body({"rank": 0, "count": 1,
                                      "interval": 2.0, "pid": 11}))
    go("GET", "/health")
    go("GET", "/clock")
    go("PUT", "/profile/0", json_body(anatomy(1.0)))
    go("PUT", "/profile/1", json_body(anatomy(2.0)))
    go("GET", "/profile")
    go("PUT", "/autotune/1", json_body({"outcome": "applied",
                                        "predicted_speedup": 1.2}))
    go("PUT", "/autotune/2", json_body({"outcome": "verified",
                                        "realized_speedup": 1.1}))
    go("GET", "/autotune")
    for i, kind in enumerate(("abort.publish", "restart.attempt")):
        eid = f"h-1-{i + 1}"
        go("PUT", f"/events/{eid}", json_body({
            "id": eid, "ts": 10.0 + i, "host": "h", "rank": 0,
            "kind": kind, "severity": "warning", "correlation_id": "h-1-1",
            "cause_id": None if i == 0 else "h-1-1", "payload": {"i": i}}))
    go("GET", "/events")
    go("GET", "/events?since_ts=10.5")
    go("GET", "/events?kind=abort.publish")
    go("PUT", "/membership/epoch", json_body({"epoch": 2, "world": ["0"]}))
    go("PUT", "/membership/epoch", json_body({"epoch": 1, "world": ["0"]}))
    go("GET", "/membership")
    go("PUT", "/abort/flag", json_body({"reason": "worker 1 exited",
                                        "rank": 1, "source": "launcher"}))
    go("PUT", "/health/1", json_body({"rank": 1, "count": 0}))
    go("GET", "/health")
    go("GET", "/serving")
    go("POST", "/infer", b"{}")
    for path in ("/peerstate", "/replay", "/projection", "/sanitizer",
                 "/alerts", "/metrics.json"):
        go("GET", path)
    go("DELETE", "/job/fn")
    go("GET", "/job/fn")
    go("DELETE", "/job")
    return out


def test_same_replies_as_the_reference():
    with serving("port") as p, serving("reference") as r:
        got, want = _script(p.port), _script(r.port)
        prom = [raw(s.port, "GET", "/metrics")[1] for s in (p, r)]
    assert [g[:3] for g in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        if g[1] == "/metrics.json":   # each server adds its own registry
            g = (*g[:3], json.dumps({k: v for k, v in json.loads(g[3])
                                     .items() if k != "launcher"}))
            w = (*w[:3], json.dumps({k: v for k, v in json.loads(w[3])
                                     .items() if k != "launcher"}))
        assert normalized(g[3]) == normalized(w[3]), g[:3]
    statuses = {(m, path): s for m, path, s, _ in got}
    assert statuses[("GET", "/job/missing")] == 404
    assert 401 in [s for m, path, s, _ in got if path == "/job/fn"]
    assert [s for m, path, s, _ in got if path == "/membership/epoch"] == \
        [200, 409]
    assert [s for m, path, s, _ in got if path == "/metrics/1"][0] == 409
    assert statuses[("GET", "/serving")] == 404
    assert statuses[("POST", "/infer")] == 503
    lines = launcher_free(prom[0])
    assert lines == launcher_free(prom[1])
    assert 'hvd_steps_total{rank="0"} 2' in "\n".join(lines)


def test_prometheus_text_is_the_references():
    import importlib

    ref_registry = importlib.import_module("horovod_tpu.metrics.registry")
    port_registry = importlib.import_module(
        "horovod_tpu_torch.metrics.registry")
    snaps = [({"rank": "0"}, snapshot(3.0, extra=True)),
             ({"rank": "1"}, snapshot(4.0))]
    assert port_registry.render_prometheus(snaps) == \
        ref_registry.render_prometheus(snaps)


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_client_against_the_other_server(client, server):
    c = SIDES[client]["client"]
    with serving(server) as srv:
        addr, port = "127.0.0.1", srv.port
        c.put_kv(addr, port, "job", "fn", b"blob", secret=SECRET)
        assert c.get_kv(addr, port, "job", "fn", secret=SECRET) == b"blob"
        assert c.get_kv(addr, port, "job", "nope", secret=SECRET) is None
        reply = c.put_kv_reply(addr, port, "health", "0",
                               json_body({"rank": 0}), secret=SECRET)
        assert reply == {"server_id": srv.server_id, "abort": None}
        reply = c.put_batch(addr, port, [("/metrics/0", b"{}"),
                                         ("/metrics/1", b"{}")],
                            secret=SECRET)
        assert reply["applied"] == 2 and reply["server_id"] == srv.server_id
        first = c.get_scope(addr, port, "metrics", secret=SECRET)
        assert first["full"] and sorted(first["entries"]) == ["0", "1"]
        c.put_kv(addr, port, "metrics", "1", b"{}", secret=SECRET)
        later = c.get_scope(addr, port, "metrics", since=first["version"],
                            secret=SECRET)
        assert not later["full"] and sorted(later["entries"]) == ["1"]
        resync = c.get_scope(addr, port, "metrics", since=10 ** 6,
                             secret=SECRET)
        assert resync["full"]
        assert isinstance(c.get_clock(addr, port, secret=SECRET), float)
        c.put_autotune_plan(addr, port, 1, {"outcome": "applied"},
                            secret=SECRET)
        c.put_profile_summary(addr, port, 0, anatomy(1.0), secret=SECRET)
        assert c.get_autotune(addr, port, secret=SECRET) == \
            srv.autotune_report()
        assert c.get_profile(addr, port, secret=SECRET) == \
            srv.profile_report()
        assert c.get_health(addr, port, secret=SECRET)["ranks"]["0"][
            "verdict"] == "live"
        c.put_kv(addr, port, "membership", "epoch",
                 json_body({"epoch": 3}), secret=SECRET)
        with pytest.raises(urllib.error.HTTPError) as err:
            c.put_kv(addr, port, "membership", "epoch",
                     json_body({"epoch": 2}), secret=SECRET)
        assert err.value.code == 409
        store = c.RemoteStore([(addr, port)], secret=SECRET)
        with pytest.raises(Exception, match="fenced|epoch"):
            store.put("membership", "epoch", json_body({"epoch": 1}))
        assert "rank=\"launcher\"" in c.get_metrics(addr, port,
                                                     secret=SECRET)
        with pytest.raises(urllib.error.HTTPError) as err:
            c.get_kv(addr, port, "job", "fn", secret=b"wrong")
        assert err.value.code == 401


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_pushers_against_the_other_server(client, server):
    """Each package's metrics and time-series pushers (their own
    registries) against the other's server: a full snapshot, then a
    delta merged into it, then a resync after the server's incarnation
    changes under the pusher."""
    if client == "port":
        from horovod_tpu_torch import metrics
        from horovod_tpu_torch.metrics import push, timeseries
    else:
        from horovod_tpu import metrics
        from horovod_tpu.metrics import push, timeseries
    with serving(server) as srv:
        addr, port = "127.0.0.1", srv.port
        mp = push.MetricsPusher(addr, port, 7, SECRET, 60.0)
        tp = timeseries.TimeseriesPusher(addr, port, 7, SECRET, 60.0)
        metrics.STEPS_TOTAL.inc(3)
        timeseries.record("step_seconds", 0.5, step=1)
        assert mp.push() and tp.push()
        metrics.STEPS_TOTAL.inc(2)
        timeseries.record("step_seconds", 0.25, step=2)
        assert mp.push() and tp.push()
        assert (mp.delta_pushes, tp.delta_pushes) == (1, 1)
        stored = json.loads(srv.get("metrics", "7"))["metrics"]
        assert stored["hvd_steps_total"]["samples"][0]["value"] == \
            metrics.STEPS_TOTAL.get()
        series = json.loads(srv.get("timeseries", "7"))["series"]
        assert series["step_seconds"]["samples"][-2:] == \
            [[1, 0.5], [2, 0.25]]
        mp._server_id = tp._server_id = "another incarnation"
        metrics.STEPS_TOTAL.inc(1)
        timeseries.record("step_seconds", 0.125, step=3)
        assert mp.push() and tp.push()
        assert (mp.resyncs, tp.resyncs) == (1, 1)
        stored = json.loads(srv.get("metrics", "7"))["metrics"]
        assert stored["hvd_steps_total"]["samples"][0]["value"] == \
            metrics.STEPS_TOTAL.get()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_replays_on_both_sides(tmp_path, writer):
    """Every scope the journal keeps (``metrics``, ``health`` and the
    other reconstructible scopes are left out by design, both sides'
    ``JOURNAL_EXCLUDED_SCOPES``) replays to what the server held."""
    journal = SIDES[writer]["journal"]
    assert journal.JOURNAL_EXCLUDED_SCOPES == \
        SIDES["port"]["journal"].JOURNAL_EXCLUDED_SCOPES
    path = str(tmp_path / "rdv.journal")
    with serving(writer, journal_path=path) as srv:
        for i in range(3):
            raw(srv.port, "PUT", f"/job/{i}", json_body(snapshot(i)))
            raw(srv.port, "PUT", f"/metrics/{i}", json_body(snapshot(i)))
        raw(srv.port, "PUT", "/batch", json_body({"entries": [
            {"p": "/health/0", "v": "e30="}, {"p": "/events/e1",
                                             "v": "eyJ4IjogMX0="}]}))
        raw(srv.port, "DELETE", "/job/1")
        raw(srv.port, "PUT", "/membership/epoch", json_body({"epoch": 4}))
        srv.put("abort", "flag", b"{}")
        srv.clear_scope("abort")
        held = {k: v for k, v in srv.store.items().items()
                if k.split("/")[1]
                not in journal.JOURNAL_EXCLUDED_SCOPES}
    assert sorted(held) == ["/events/e1", "/job/0", "/job/2",
                            "/membership/epoch"]
    for side in ("port", "reference"):
        store = SIDES[side]["store"].ShardedKVStore()
        assert SIDES[side]["journal"].replay(path, store) > 0
        assert store.items() == held, side


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_relay_batches_upstream(client, server):
    relay = SIDES[client]["relay"]
    c = SIDES[client]["client"]
    with serving(server) as srv:
        daemon = relay.RelayDaemon("127.0.0.1", srv.port, secret=SECRET,
                                   port=0, flush_ms=60_000)
        daemon.start()
        try:
            for rank in range(3):
                c.put_kv("127.0.0.1", daemon.port, "metrics", str(rank),
                         json_body(snapshot(rank)), secret=SECRET)
            c.put_kv("127.0.0.1", daemon.port, "metrics", "0",
                     json_body(snapshot(9.0)), secret=SECRET)
            assert daemon.pending() == 3
            served = srv.requests_served
            srv.put("abort", "flag", json_body({"reason": "r"}))
            assert daemon.flush_now()
            assert srv.requests_served == served + 1   # one PUT /batch
            assert daemon.abort_cache == {"reason": "r"}
            assert daemon.upstream_id == srv.server_id
            for rank, v in ((0, 9.0), (1, 1.0), (2, 2.0)):
                assert json.loads(srv.get("metrics", str(rank))) == \
                    snapshot(v)
            reply = c.put_kv_reply("127.0.0.1", daemon.port, "health", "0",
                                   json_body({"rank": 0}), secret=SECRET)
            assert reply["relay"] and reply["abort"] == {"reason": "r"}
        finally:
            daemon.stop()
