"""Host identity (Horovod's ``runner/common/util/host_hash.py``; the JAX
package's ``runner/host_hash.py``): two spellings of one machine
(``localhost`` and its name) must land in one local-rank group, so hosts
are told apart by a hash of the machine, not by how they are written."""

from __future__ import annotations

import hashlib
import socket


def host_hash(salt: str = "") -> str:
    """This machine's hash: the md5 of its hostname (without the domain)
    and ``salt``, which lets slots on one machine pose as distinct
    hosts."""
    host = socket.gethostname().split(".")[0]
    return hashlib.md5(f"{host}-{salt}".encode()).hexdigest()


def hosts_equivalent(a: str, b: str) -> bool:
    """True when two host names resolve to a common address."""
    if a == b:
        return True
    try:
        ia = {r[4][0] for r in socket.getaddrinfo(a, None)}
        ib = {r[4][0] for r in socket.getaddrinfo(b, None)}
    except socket.gaierror:
        return False
    return bool(ia & ib)
