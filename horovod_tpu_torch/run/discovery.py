"""TPU pod host discovery for the launcher: the port of
``horovod_tpu/run/discovery.py``, kept as the reference's API behind
``--tpu`` (no GPU counterpart is invented: a GPU job names its hosts
with ``-H`` or ``--hostfile``).

The reference launcher probes ssh reachability and NICs to find usable
hosts/interfaces (reference run/run.py:62-115 cached ssh checks,
:198-268 ring-wise NIC intersection).  On TPU pods neither applies: the
platform already knows the workers.  SURVEY §7.1's stated replacement is
metadata-based resolution — sources, in order:

1. ``HVD_TPU_HOSTS`` — explicit override, same ``h1:8,h2:8`` syntax as
   ``-H``;
2. ``TPU_WORKER_HOSTNAMES`` — comma-separated worker hostnames, the env
   the TPU runtime provisions on pod VMs (what jax.distributed reads);
3. the GCE metadata server's ``worker-network-endpoints`` instance
   attribute (comma-separated entries whose LAST ``:``-field is the
   worker IP — the format jax's cloud_tpu_cluster parser consumes).

Slots per host default to the locally visible chip count, read without
initializing any TPU runtime (the launcher must not grab libtpu's
exclusive chip lock before its workers do).
"""

from __future__ import annotations

import os
import urllib.error
import urllib.request
from typing import List, Optional

from .hosts import HostInfo, parse_hosts

_METADATA_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "attributes/worker-network-endpoints"
)


def _metadata_endpoints(timeout: float = 2.0) -> Optional[str]:
    req = urllib.request.Request(
        _METADATA_URL, headers={"Metadata-Flavor": "Google"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode()
    except (urllib.error.URLError, OSError, TimeoutError):
        return None


def _local_chip_count() -> int:
    """Local chips WITHOUT initializing a TPU runtime: importing jax here
    would take libtpu's exclusive lock inside the launcher and break the
    workers it spawns.  /dev/accel* is the chip inventory on TPU VMs."""
    env = os.environ.get("HVD_TPU_SLOTS")
    if env:
        return max(int(env), 1)
    import glob

    chips = len(glob.glob("/dev/accel*"))
    return chips if chips > 0 else 4  # 4 = common v5e host shape


def discover_tpu_hosts(default_slots: Optional[int] = None) -> Optional[List[HostInfo]]:
    """Resolve the pod's worker hosts, or None when nothing is
    discoverable (caller falls back to localhost)."""
    explicit = os.environ.get("HVD_TPU_HOSTS")
    if explicit:
        return parse_hosts(explicit)

    slots = default_slots or _local_chip_count()

    names = os.environ.get("TPU_WORKER_HOSTNAMES")
    if names:
        return [HostInfo(h.strip(), slots)
                for h in names.split(",") if h.strip()]

    endpoints = _metadata_endpoints()
    if endpoints:
        hosts = []
        for entry in endpoints.split(","):
            entry = entry.strip()
            if not entry:
                continue
            # the worker IP is the last :-field (matching jax
            # cloud_tpu_cluster's split(':')[-1] of each entry); bare
            # "ip" entries pass through unchanged
            hosts.append(HostInfo(entry.split(":")[-1], slots))
        return hosts or None
    return None
