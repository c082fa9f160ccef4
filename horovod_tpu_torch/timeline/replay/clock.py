"""Clock-offset estimation against the rendezvous server: the port of
``horovod_tpu/timeline/replay/clock.py``.

The per-rank timelines timestamp events with each process's own
monotonic clock (``time.perf_counter`` relative to the Timeline's
origin) — fine for one rank, useless across ranks: a merged trace built
from raw timestamps can show a collective "ending" on one rank before it
"started" on another, and a cross-rank critical path built on such a
trace is fiction.  dPRO solves this with clock synchronization before
replay (Hu et al., MLSys 2022, §3.1); the classic transport is NTP's
four-timestamp exchange.

Here the job already has one shared, always-up endpoint: the launcher's
rendezvous server.  ``GET /clock`` (run/http_server.py) returns the
server's monotonic clock; each rank samples it a few times and keeps the
minimum-RTT sample — the one whose midpoint approximation is least
polluted by queueing — estimating::

    offset_us = server_us - (t0 + t1) / 2        # local → server clock

The reference's ``Timeline.initialize`` runs this handshake once per
trace and persists the result as ``<dir>/<rank>/clock_sync.json``;
``merge_traces`` shifts each rank's events by its offset so the whole job
shares the server's clock.

The port has no rendezvous server yet (``run/``, ROADMAP queue 1, item
17), so it has no ``GET /clock`` client: :func:`sample_offset` and
:func:`estimate_offset` take the server's clock as a callable
(``server_clock_us``) and raise ``NotImplementedError`` without one, and
the port's ``Timeline`` writes no ``clock_sync.json``.  The merge and the
stitcher already treat a trace without sidecars as unaligned.  The error bound is ±rtt/2 — LAN round trips are tens of µs,
far below the negotiation skews (hundreds of µs to ms) the replay
engine attributes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional


def _default_clock_us() -> float:
    return time.perf_counter() * 1e6


def _server_clock(addr: str, port: int, secret: Optional[bytes],
                  timeout: float,
                  server_clock_us: Optional[Callable[[], float]]
                  ) -> Callable[[], float]:
    if server_clock_us is not None:
        return server_clock_us
    del addr, port, secret, timeout
    from ... import metrics

    metrics.refuse_rendezvous("the replay clock handshake (GET /clock)")


def sample_offset(addr: str, port: int,
                  secret: Optional[bytes] = None,
                  local_clock_us: Optional[Callable[[], float]] = None,
                  timeout: float = 2.0,
                  server_clock_us: Optional[Callable[[], float]] = None
                  ) -> Dict[str, float]:
    """One handshake leg: ``{"offset_us", "rtt_us"}`` for a single
    round trip to the server's clock, midpoint-approximated.
    ``server_clock_us()`` reads the server's clock in µs; without it the
    call raises ``NotImplementedError`` (the rendezvous client is not
    ported yet)."""
    server = _server_clock(addr, port, secret, timeout, server_clock_us)
    clock = local_clock_us or _default_clock_us
    t0 = clock()
    server_us = float(server())
    t1 = clock()
    return {
        "offset_us": server_us - (t0 + t1) / 2.0,
        "rtt_us": t1 - t0,
    }


def estimate_offset(addr: str, port: int,
                    secret: Optional[bytes] = None,
                    samples: int = 8,
                    local_clock_us: Optional[Callable[[], float]] = None,
                    timeout: float = 2.0,
                    server_clock_us: Optional[Callable[[], float]] = None
                    ) -> Dict[str, float]:
    """Best-of-N offset estimate: run ``samples`` handshake legs and
    keep the minimum-RTT one (its midpoint assumption has the least
    queueing asymmetry to hide behind).  Raises on total failure, and
    ``NotImplementedError`` without ``server_clock_us``."""
    server = _server_clock(addr, port, secret, timeout, server_clock_us)
    samples = max(1, int(samples))
    best: Optional[Dict[str, float]] = None
    failures = 0
    last_err: Optional[Exception] = None
    for _ in range(samples):
        try:
            s = sample_offset(addr, port, secret=secret,
                              local_clock_us=local_clock_us,
                              timeout=timeout, server_clock_us=server)
        except Exception as e:  # noqa: BLE001 — count, keep sampling
            failures += 1
            last_err = e
            if best is None and failures >= 2:
                # server unreachable, not flaky: don't burn the full
                # N×timeout budget inside every rank's initialize
                break
            continue
        if best is None or s["rtt_us"] < best["rtt_us"]:
            best = s
    if best is None:
        raise RuntimeError(
            f"clock handshake failed: {samples} samples, last error: "
            f"{last_err}"
        )
    return {
        "offset_us": best["offset_us"],
        "rtt_us": best["rtt_us"],
        "samples": samples - failures,
        "method": "min-rtt midpoint vs rendezvous GET /clock",
    }
