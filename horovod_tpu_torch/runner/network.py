"""Network interfaces and reachability (Horovod's
``runner/common/util/network.py`` and the NIC ring check of
``runner/task_fn.py``; the JAX package's ``runner/network.py``)."""

from __future__ import annotations

import socket
from typing import Dict, List


def get_local_interfaces(ipv4_only: bool = True) -> Dict[str, List[str]]:
    """Interface name -> its addresses on this machine: from ``psutil``
    where it is installed, else IPv4 only, one address an interface, from
    the kernel's ``SIOCGIFADDR``."""
    try:
        import psutil
    except ImportError:
        return _ioctl_interfaces()
    out: Dict[str, List[str]] = {}
    for name, addrs in psutil.net_if_addrs().items():
        ips = [a.address for a in addrs
               if a.family == socket.AF_INET
               or (not ipv4_only and a.family == socket.AF_INET6)]
        if ips:
            out[name] = ips
    return out


def _ioctl_interfaces() -> Dict[str, List[str]]:
    import fcntl
    import struct

    out: Dict[str, List[str]] = {}
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for _, name in socket.if_nameindex():
            try:
                packed = fcntl.ioctl(s.fileno(), 0x8915,  # SIOCGIFADDR
                                     struct.pack("256s",
                                                 name.encode()[:15]))
            except OSError:
                continue    # no IPv4 address
            out[name] = [socket.inet_ntoa(packed[20:24])]
    return out


def can_connect(host: str, port: int, timeout: float = 2.0) -> bool:
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


def probe_reachable(addresses: List[str], port: int,
                    timeout: float = 2.0) -> List[str]:
    """Which of ``addresses`` accept a TCP connection on ``port``: the
    ring probe's step, in which each host tries the next one's addresses,
    so that one-way or NAT'ed interfaces drop out."""
    return [a for a in addresses if can_connect(a, port, timeout)]


def local_addresses() -> List[str]:
    return sorted({ip for ips in get_local_interfaces().values()
                   for ip in ips})


def filter_common_interfaces(per_host_reachable: Dict[str, List[str]]
                             ) -> List[str]:
    """What every host could reach (Horovod's ``driver_service.py:218``
    ``get_common_interfaces``)."""
    sets = [set(v) for v in per_host_reachable.values()]
    if not sets:
        return []
    return sorted(set.intersection(*sets))


def get_free_port(bind: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((bind, 0))
        return s.getsockname()[1]
