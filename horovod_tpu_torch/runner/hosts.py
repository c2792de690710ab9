"""Host/slot parsing and rank assignment: the port's own copy of the JAX
package's ``runner/hosts.py`` (Horovod's ``runner/common/util/hosts.py``:
``parse_hosts``, ``get_host_assignments:100`` packing ranks onto host
slots)."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """Parse ``host1:2,host2:4`` (reference hosts.py parse_hosts)."""
    out = []
    for part in hosts_string.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            out.append(HostInfo(name, int(slots)))
        else:
            out.append(HostInfo(part, 1))
    return out


def parse_hostfile(path: str) -> List[HostInfo]:
    """Hostfile lines: ``hostname slots=N`` (mpirun style) or ``host:N``."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            if "slots=" in line:
                name, _, rest = line.partition(" ")
                slots = int(rest.split("slots=")[1].split()[0])
                out.append(HostInfo(name.strip(), slots))
            else:
                out.extend(parse_hosts(line))
    return out


def slot_env_vars(slot: SlotInfo) -> dict:
    """The HVT_* identity env for one slot, which ``basics.init`` reads."""
    return {
        "HVT_PROCESS_ID": str(slot.rank),
        "HVT_NUM_PROCESSES": str(slot.size),
        "HVT_LOCAL_PROCESS_ID": str(slot.local_rank),
        "HVT_LOCAL_SIZE": str(slot.local_size),
        "HVT_CROSS_RANK": str(slot.cross_rank),
        "HVT_CROSS_SIZE": str(slot.cross_size),
        "HVT_HOSTNAME": slot.hostname,
    }


def get_host_assignments(hosts: List[HostInfo], np: int) -> List[SlotInfo]:
    """Pack ``np`` ranks onto host slots in host order, producing
    rank/local_rank/cross_rank per slot (reference hosts.py:100).

    cross_rank: index of the host among hosts that have at least one rank
    at this local_rank — matching the reference's cross-communicator
    construction for hierarchical ops.
    """
    total = sum(h.slots for h in hosts)
    if np > total:
        raise ValueError(
            f"requested -np {np} exceeds available slots {total} "
            f"({','.join(f'{h.hostname}:{h.slots}' for h in hosts)})")
    slots: List[SlotInfo] = []
    rank = 0
    used_hosts = []
    for h in hosts:
        if rank >= np:
            break
        n_here = min(h.slots, np - rank)
        used_hosts.append((h.hostname, n_here))
        for lr in range(n_here):
            slots.append(SlotInfo(hostname=h.hostname, rank=rank,
                                  local_rank=lr, cross_rank=0, size=np,
                                  local_size=n_here,
                                  cross_size=0))
            rank += 1
    # fill cross ranks: for each local_rank, hosts having that slot
    for s in slots:
        peers = [h for h, n in used_hosts if n > s.local_rank]
        s.cross_rank = peers.index(s.hostname)
        s.cross_size = len(peers)
    return slots
