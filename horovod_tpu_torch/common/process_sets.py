"""Process sets: named subsets of ranks that collectives run over
(Horovod's ``common/process_sets.py``; the JAX package's
``horovod_tpu/common/process_sets.py``).

A set other than the global one owns a ``torch.distributed`` group made by
``new_group``. ``new_group`` is collective over the whole world, so every
process calls :func:`add_process_set` and :func:`remove_process_set` (and
``init(process_sets=...)``) with the same sets in the same order, members
or not.

Semantics the port pins:

- A collective over a set is issued by its members only. A non-member's
  call raises ``ValueError``, as the JAX package's engine path does. The
  JAX package's traced path differs: its XLA collective also reduces the
  set's complement among itself, and non-members are told to ignore that
  result. The port runs nothing on non-members.
- Average over a set divides by the set's size.
"""

from __future__ import annotations

import threading

import torch.distributed as dist

from horovod_tpu_torch.common import basics

_lock = threading.Lock()


class ProcessSet:
    def __init__(self, ranks=None):
        """``ranks=None`` means all processes (the global set)."""
        self.ranks = sorted(int(r) for r in ranks) \
            if ranks is not None else None
        self.process_set_id = None   # assigned by add_process_set / init
        self._group = None           # the torch.distributed group, members

    def included(self) -> bool:
        """Is this process's rank a member of the set (exact membership)?"""
        return self.ranks is None or basics.rank() in self.ranks

    def size(self) -> int:
        return basics.size() if self.ranks is None else len(self.ranks)

    def rank_in_set(self, global_rank: int) -> int:
        return global_rank if self.ranks is None \
            else self.ranks.index(global_rank)

    def global_ranks(self) -> list:
        return list(range(basics.size())) if self.ranks is None \
            else list(self.ranks)

    def group(self):
        """The ``torch.distributed`` group that this process's collectives
        over the set run on. Raises ``ValueError`` for a non-member or for
        a set that is not registered."""
        if self.ranks is None:
            return dist.group.WORLD
        if not self.included():
            raise ValueError(
                f"rank {basics.rank()} is not in process set {self.ranks}; "
                "only member ranks may call this collective")
        if self._group is None:
            raise ValueError(f"{self!r} is not registered: call "
                             "hvt.add_process_set on every process first")
        return self._group

    def __repr__(self):
        r = "global" if self.ranks is None else self.ranks
        return f"ProcessSet(id={self.process_set_id}, ranks={r})"


global_process_set = ProcessSet(None)


def add_process_set(process_set) -> ProcessSet:
    """Register a process set (a list of ranks or a :class:`ProcessSet`)
    and return it with an id. A set whose ranks are already registered
    returns the registered one; otherwise ids are assigned in order. Every
    process must make the same calls in the same order."""
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(list(process_set))
    ranks = process_set.ranks
    n = basics.size()
    if ranks is not None and (len(set(ranks)) != len(ranks) or not ranks
                              or ranks[0] < 0 or ranks[-1] >= n):
        raise ValueError(f"process set ranks {ranks} must be distinct "
                         f"ranks in [0, {n})")
    with _lock:
        world = basics._world()
        for ps in world.process_sets.values():
            if ps.ranks == ranks:
                return ps
        # a set of every rank reduces on the world's own group
        process_set._group = (dist.group.WORLD if ranks == list(range(n))
                              else dist.new_group(ranks))
        process_set.process_set_id = world.next_process_set_id
        world.next_process_set_id += 1
        world.process_sets[process_set.process_set_id] = process_set
    return process_set


def remove_process_set(process_set: ProcessSet):
    """Unregister a set; the global set (id 0) is never removed. Its
    group's communicator is kept until ``shutdown``."""
    with _lock:
        registry = basics._world().process_sets
        if process_set.process_set_id in registry \
                and process_set.process_set_id != 0:
            del registry[process_set.process_set_id]
            process_set.process_set_id = None
            process_set._group = None


def process_set_included_ranks(process_set_id: int):
    with _lock:
        return basics._world().process_sets[process_set_id].global_ranks()
