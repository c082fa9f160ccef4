"""Host parsing and slot allocation: the port of
``horovod_tpu/run/hosts.py``, as it is.

Mirror of the reference's host handling: ``-H host1:4,host2:4`` / hostfile
parsing (reference run/run.py:696-740) and gloo_run's slot allocation that
assigns each process a ``SlotInfo(rank, local_rank, cross_rank, sizes...)``
(reference run/gloo_run.py:53-111)."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List


@dataclass
class HostInfo:
    hostname: str
    slots: int


@dataclass
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """``"host1:2,host2:4"`` → HostInfo list; bare hostnames get 1 slot
    (reference run/run.py parse of -H)."""
    hosts = []
    for part in hosts_string.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^(?P<host>[\w.\-\[\]]+):(?P<slots>\d+)$", part)
        if m:
            hosts.append(HostInfo(m.group("host"), int(m.group("slots"))))
        else:
            hosts.append(HostInfo(part, 1))
    return hosts


def parse_hostfile(path: str) -> List[HostInfo]:
    """Hostfile lines ``hostname slots=N`` (reference run/run.py hostfile
    format, --hostfile)."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            m = re.match(r"^(?P<host>[\w.\-]+)(\s+slots=(?P<slots>\d+))?$",
                         line)
            if not m:
                raise ValueError(f"bad hostfile line: {line!r}")
            slots = int(m.group("slots") or 1)
            hosts.append(HostInfo(m.group("host"), slots))
    return hosts


def allocate_slots(hosts: List[HostInfo], np: int) -> List[SlotInfo]:
    """Fill hosts in order (map-by slot) until ``np`` ranks are placed —
    the reference's _allocate (run/gloo_run.py:53-111): rank = global order,
    local_rank = index on host, cross_rank = index of this local_rank's
    "column" across hosts."""
    total = sum(h.slots for h in hosts)
    if np > total:
        raise ValueError(
            f"requested np={np} exceeds available slots {total}"
        )
    placements: List[List[str]] = []  # per host: hostnames of placed ranks
    slots: List[SlotInfo] = []
    remaining = np
    per_host: List[int] = []
    for h in hosts:
        take = min(h.slots, remaining)
        per_host.append(take)
        remaining -= take
        if remaining == 0:
            break
    hosts_used = hosts[: len(per_host)]

    rank = 0
    for hi, h in enumerate(hosts_used):
        for lr in range(per_host[hi]):
            cross_size = sum(1 for n in per_host if n > lr)
            cross_rank = sum(1 for n in per_host[:hi] if n > lr)
            slots.append(SlotInfo(
                hostname=h.hostname, rank=rank, size=np,
                local_rank=lr, local_size=per_host[hi],
                cross_rank=cross_rank, cross_size=cross_size,
            ))
            rank += 1
    return slots
