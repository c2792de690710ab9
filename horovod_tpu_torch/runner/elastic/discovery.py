"""Host discovery for elastic jobs: the port's copy of the JAX package's
``runner/elastic/discovery.py`` (Horovod's
``runner/elastic/discovery.py``: ``HostManager:79``,
``HostDiscoveryScript`` — a user script prints ``host:slots`` lines;
blacklisting with optional cooldown).

The discovery source is pluggable: a user script (re-run every poll), a
fixed host list (for static-within-elastic tests), or any object with a
``find_available_hosts_and_slots() -> {host: slots}`` method.
"""

from __future__ import annotations

import random
import subprocess
import threading
import time
from typing import Dict, List, Optional


class HostDiscovery:
    """Interface: return the currently available hosts and their slots."""

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Runs a user-provided executable that prints one host per line,
    either ``hostname:slots`` or bare ``hostname`` (then ``default_slots``
    applies). A failing or timed-out script RAISES — callers that poll
    (the driver's discovery thread) catch and keep the previous view, so
    a transient discovery blip never reads as "all hosts gone" (reference
    ``driver.py`` ``_discover_hosts`` retains state on a failed poll).
    """

    def __init__(self, script: str, default_slots: int = 1,
                 timeout: float = 10.0):
        self._script = script
        self._default_slots = default_slots
        self._timeout = timeout

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.run(
            self._script, shell=True, capture_output=True,
            timeout=self._timeout, check=True).stdout.decode()
        hosts: Dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                name, _, slots = line.rpartition(":")
                try:
                    hosts[name] = int(slots)
                except ValueError:
                    continue
            else:
                hosts[line] = self._default_slots
        return hosts


class FixedHostDiscovery(HostDiscovery):
    """A constant host set (``host1:2,host2:2`` string or dict)."""

    def __init__(self, hosts):
        if isinstance(hosts, str):
            from horovod_tpu_torch.runner.hosts import parse_hosts

            hosts = {h.hostname: h.slots for h in parse_hosts(hosts)}
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class DiscoveredHosts:
    """Immutable snapshot of one discovery poll, with blacklist applied.

    ``host_assignment_order`` is stable: hosts already present keep their
    relative order; new hosts append — so surviving ranks stay on the same
    hosts across updates (reference ``driver.py:228`` stable ranks).
    """

    def __init__(self, host_slots: Dict[str, int],
                 host_assignment_order: List[str]):
        self.host_slots = dict(host_slots)
        self.host_assignment_order = list(host_assignment_order)

    def count_available_slots(self) -> int:
        return sum(self.host_slots.get(h, 0)
                   for h in self.host_assignment_order)

    def update(self, host_slots: Dict[str, int]) -> "DiscoveredHosts":
        order = [h for h in self.host_assignment_order if h in host_slots]
        order += sorted(h for h in host_slots
                        if h not in self.host_assignment_order)
        return DiscoveredHosts(host_slots, order)

    def __eq__(self, other):
        return (isinstance(other, DiscoveredHosts)
                and self.host_slots == other.host_slots
                and self.host_assignment_order
                == other.host_assignment_order)

    def __repr__(self):
        return f"DiscoveredHosts({self.host_slots})"


class HostManager:
    """Tracks the live host set across discovery polls and owns the
    blacklist (reference ``discovery.py:79``)."""

    def __init__(self, discovery: HostDiscovery,
                 cooldown_range: Optional[tuple] = None):
        self._discovery = discovery
        self._lock = threading.Lock()
        self._current_hosts = DiscoveredHosts({}, [])
        self._blacklist: Dict[str, float] = {}   # host → retry-after ts
        self._cooldown_range = cooldown_range

    @property
    def current_hosts(self) -> DiscoveredHosts:
        with self._lock:
            return self._current_hosts

    def update_available_hosts(self) -> bool:
        """Poll discovery once; returns True when the usable host set
        changed (the driver then notifies workers)."""
        found = self._discovery.find_available_hosts_and_slots()
        now = time.time()
        with self._lock:
            usable = {h: s for h, s in found.items()
                      if not self._is_blacklisted_locked(h, now)}
            new = self._current_hosts.update(usable)
            changed = new != self._current_hosts
            self._current_hosts = new
            return changed

    def blacklist(self, host: str):
        """Mark a host bad; with a cooldown range it may return after a
        randomized backoff, otherwise it is out for the job's lifetime."""
        with self._lock:
            if self._cooldown_range is not None:
                lo, hi = self._cooldown_range
                self._blacklist[host] = time.time() + random.uniform(lo, hi)
            else:
                self._blacklist[host] = float("inf")
            hs = dict(self._current_hosts.host_slots)
            hs.pop(host, None)
            self._current_hosts = self._current_hosts.update(hs)

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            return self._is_blacklisted_locked(host, time.time())

    def blacklisted_count(self) -> int:
        """Hosts currently serving a blacklist sentence (expired cooldowns
        are purged on the way)."""
        with self._lock:
            now = time.time()
            return sum(1 for h in list(self._blacklist)
                       if self._is_blacklisted_locked(h, now))

    def _is_blacklisted_locked(self, host: str, now: float) -> bool:
        until = self._blacklist.get(host)
        if until is None:
            return False
        if now >= until:
            del self._blacklist[host]
            return False
        return True
