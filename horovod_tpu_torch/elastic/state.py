"""Elastic state objects: the port's copy of the JAX package's
``horovod_tpu/elastic/state.py`` (Horovod's ``common/elastic.py:26-144``).

- :class:`State` and :class:`ObjectState`: commit / restore / sync of
  tracked attributes, and the host-update check at each commit.
- :class:`ReplicatedState`: the checkpointless layer. Every ``commit()``
  also refreshes versioned, CRC-stamped replica shards of this rank's
  snapshot on K-1 peer ranks, so ``sync()`` after a lost rank rebuilds its
  state from a surviving peer instead of restarting from a checkpoint.

The torch objects' states (``TorchState``, ``ReplicatedTorchState``) are
in ``elastic/torch_state.py``. The replication core is plain Python over
an injectable collectives backend (four methods: ``rank``, ``size``,
``host``, ``allgather``); the default one, :class:`HvtCollectives`, runs the
port's ``allgather_object`` over process sets of the replication groups.

Two semantics follow Horovod's ``common/elastic.py`` rather than the JAX
package: ``check_host_updates`` agrees across the world (one small
allreduce a commit), so every rank raises ``HostsUpdatedInterrupt`` at the
same commit; and ``on_reset`` drops the updates the reset has absorbed.
Both matter on NCCL, where a rank that raised alone would leave its peers
blocked in the next step's collective.
"""

from __future__ import annotations

import copy
import os
import pickle
import socket
import struct
import zlib

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HostsUpdatedInterrupt)


def raise_if_aborted():
    """``HorovodInternalError`` when ``basics.abort`` tore the world down
    (a peer died): nothing of the step in flight may be committed."""
    reason = basics.aborted()
    if reason is not None:
        raise HorovodInternalError(f"the process group was aborted: "
                                   f"{reason}")


def _any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (one Max allreduce);
    ``flag`` itself outside a world of several processes."""
    if not basics.is_initialized() or basics.size() == 1:
        return flag
    import torch

    from horovod_tpu_torch.ops import collective_ops as C

    t = torch.tensor([int(flag)], dtype=torch.int32, device=basics.device())
    return bool(C.allreduce(t, op=C.Max).item())


class State:
    """Tracked training state with commit / restore / sync (Horovod's
    ``common/elastic.py:26``).

    - ``commit()``: snapshot the state and check for pending host updates
      (raising HostsUpdatedInterrupt at a safe point).
    - ``restore()``: roll back to the last commit (after a failure).
    - ``sync()``: broadcast state from the new rank 0 after a
      re-initialization.
    """

    def __init__(self, **kwargs):
        self._host_messages = []
        self._reset_callbacks = []
        for k, v in kwargs.items():
            setattr(self, k, v)

    def register_reset_callbacks(self, callbacks):
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        # the new world already reflects every update received so far
        self._host_messages.clear()
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, timestamp, update_res):
        self._host_messages.append((timestamp, update_res))

    def commit(self):
        raise_if_aborted()
        self.save()
        self.check_host_updates()

    def check_host_updates(self):
        """Raise HostsUpdatedInterrupt on every rank if any rank was told
        of a host-set change since the last check (Horovod's
        ``common/elastic.py:73-93``)."""
        pending = bool(self._host_messages)
        self._host_messages.clear()
        if _any_rank(pending):
            raise HostsUpdatedInterrupt(skip_sync=False)

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        pass


class ObjectState(State):
    """Snapshot of plain Python attributes (Horovod's
    ``common/elastic.py:112``)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._saved_state = {}
        self.save()

    def _tracked(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def save(self):
        self._saved_state = copy.deepcopy(self._tracked())

    def restore(self):
        for k, v in copy.deepcopy(self._saved_state).items():
            setattr(self, k, v)

    def sync(self):
        from horovod_tpu_torch.ops.functions import broadcast_object

        synced = broadcast_object(self._tracked(), root_rank=0,
                                  name="elastic.ObjectState")
        for k, v in synced.items():
            setattr(self, k, v)
        self.save()


# ---------------------------------------------------------------------------
# checkpointless recovery: peer-replicated shards
# ---------------------------------------------------------------------------

class ShardCorruptError(RuntimeError):
    """A replica shard failed its magic/CRC/length check on decode."""


class ReplicaUnavailableError(RuntimeError):
    """No intact replica exists for this rank's state — the caller must
    fall back to the application's own restore (checkpoint)."""


# Shard wire format: a fixed header + pickled snapshot payload. The CRC
# covers the payload only (the header fields are validated structurally)
# so a bit-flip anywhere in the blob is caught before it becomes
# somebody's optimizer state.
_SHARD_MAGIC = b"HVTS"
_SHARD_HEADER = struct.Struct("<4sqiIq")  # magic, version, owner, crc, len


def encode_shard(owner: int, version: int, payload: bytes) -> bytes:
    """``payload`` (the pickled snapshot) framed as a versioned,
    CRC-stamped replica shard."""
    return _SHARD_HEADER.pack(_SHARD_MAGIC, int(version), int(owner),
                              zlib.crc32(payload) & 0xFFFFFFFF,
                              len(payload)) + payload


def decode_shard(blob: bytes):
    """``(owner, version, payload)`` — raises :class:`ShardCorruptError`
    on any framing or CRC mismatch."""
    if len(blob) < _SHARD_HEADER.size:
        raise ShardCorruptError(
            f"shard truncated: {len(blob)} < header "
            f"{_SHARD_HEADER.size}")
    magic, version, owner, crc, n = _SHARD_HEADER.unpack_from(blob)
    if magic != _SHARD_MAGIC:
        raise ShardCorruptError(f"bad shard magic {magic!r}")
    payload = blob[_SHARD_HEADER.size:]
    if len(payload) != n:
        raise ShardCorruptError(
            f"shard length mismatch: header says {n}, got "
            f"{len(payload)}")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ShardCorruptError(
            f"shard CRC mismatch for owner {owner} v{version}")
    return int(owner), int(version), payload


def replica_group_size() -> int:
    """Replication factor K (``HVT_REPLICA_GROUP_SIZE``, default 2):
    each rank's committed state lives on itself plus K-1 peers."""
    try:
        return max(1, int(os.environ.get("HVT_REPLICA_GROUP_SIZE", "")
                          or 2))
    except ValueError:
        return 2


def replication_enabled() -> bool:
    """``HVT_STATE_REPLICATION`` gate (default on): ``0`` turns every
    ReplicatedState into its plain base class — commits stop exchanging
    shards and sync falls back to the broadcast path."""
    return os.environ.get("HVT_STATE_REPLICATION", "1") not in (
        "0", "off", "false")


def partial_fallback_enabled() -> bool:
    """``HVT_PARTIAL_FALLBACK`` gate (default on): when only SOME
    lineages lost every intact replica, ranks with recoverable lineages
    keep their peer-rebuilt state and ONLY the lost lineages restore
    from the application fallback. ``0`` restores the
    all-or-nothing semantics — every rank takes the fallback
    together — for applications whose state is gang-replicated rather
    than per-lineage (a data-parallel optimizer restored from an older
    checkpoint on one rank only would diverge from its peers)."""
    return os.environ.get("HVT_PARTIAL_FALLBACK", "1") not in (
        "0", "off", "false")


def _interleave_by_host(ranks, hosts_by_rank):
    """Round-robin ranks across their hosts (h0's first slot, h1's
    first slot, ..., h0's second slot, ...): chunking the result into
    groups of k puts every group on k distinct hosts whenever there
    are >= k hosts."""
    by_host = {}
    order = []
    for r in ranks:
        h = hosts_by_rank[r]
        if h not in by_host:
            by_host[h] = []
            order.append(h)
        by_host[h].append(r)
    out = []
    depth = max(len(v) for v in by_host.values()) if by_host else 0
    for i in range(depth):
        for h in order:
            if i < len(by_host[h]):
                out.append(by_host[h][i])
    return out


def rack_of(host) -> str:
    """The topology group of a host id: the prefix before ``/`` when
    ``HVT_TOPO_HOST`` carries a rack dimension (``rack0/h3``), else
    ``None`` (flat topology — every host stands alone)."""
    h = str(host)
    return h.split("/", 1)[0] if "/" in h else None


def build_replica_groups(hosts_by_rank, k):
    """Partition ranks 0..n-1 into replication groups of ~k members,
    each spanning distinct hosts wherever the topology allows, and
    preferring SAME-RACK/different-host peers when ``HVT_TOPO_HOST``
    carries a rack dimension (``rack/host``, the JAX package's
    topology-weighted placement).

    Within each rack that has at least k distinct hosts, ranks are
    interleaved round-robin across that rack's hosts and chunked into
    rack-local groups — replication traffic stays inside the rack
    while a host SIGKILL still cannot take a lineage and all of its
    replicas (every emitted group spans distinct hosts — a chunk that
    per-host count skew folds onto one host is never kept as-is).
    Rack remainders, racks too small to satisfy the cross-host
    guarantee on their own, and rack-less hosts pool into the classic
    global interleave, so a balanced flat topology (no ``/`` anywhere)
    produces exactly the pre-rack plan; a skewed one scatters
    skew-folded chunks across cross-host groups instead of keeping
    them. A trailing remainder group of one is merged into its
    predecessor (a group of one replicates nothing). Deterministic in
    its inputs: every rank computes the identical plan from the same
    gathered rank→host table."""
    n = len(hosts_by_rank)
    k = max(1, min(int(k), n))
    # first-seen rack order keeps the plan a pure function of the table
    racks = {}
    rack_order = []
    for r in range(n):
        rk = rack_of(hosts_by_rank[r])
        if rk not in racks:
            racks[rk] = []
            rack_order.append(rk)
        racks[rk].append(r)
    groups = []
    pool = []
    for rk in rack_order:
        ranks = racks[rk]
        hosts = {hosts_by_rank[r] for r in ranks}
        if rk is None or len(hosts) < k or len(ranks) < k:
            # cannot guarantee cross-host placement rack-locally —
            # fall back to the global pool (the pre-rack behavior)
            pool.extend(ranks)
            continue
        inter = _interleave_by_host(ranks, hosts_by_rank)
        whole = (len(inter) // k) * k
        for i in range(0, whole, k):
            g = inter[i:i + k]
            # host-count skew can fold a round-robin chunk onto ONE
            # host (three ranks on h0 + one on h1 at k=2 interleaves
            # to [0,3,1,2] and chunk [1,2] is all-h0) — such a chunk
            # would let a host SIGKILL take a lineage and all of its
            # replicas, so it rides the global pool instead
            if len({hosts_by_rank[r] for r in g}) > 1:
                groups.append(g)
            else:
                pool.extend(g)
        pool.extend(inter[whole:])  # remainder rides the global pool
    if pool:
        inter = _interleave_by_host(pool, hosts_by_rank)
        same_host = []
        for i in range(0, len(inter), k):
            g = inter[i:i + k]
            if len(g) > 1 and len({hosts_by_rank[r] for r in g}) == 1:
                same_host.append(g)
            else:
                groups.append(g)
        # the same skew can fold a pool chunk too: scatter those ranks
        # one-per-group across existing cross-host groups (adding a
        # member keeps a group cross-host). Only a world without
        # cross-host groups to absorb them (single-host topologies)
        # keeps same-host groups — replication within the host is
        # still better than none, and matches the pre-rack plan there.
        spill = [r for g in same_host for r in g]
        targets = [g for g in groups
                   if len({hosts_by_rank[r] for r in g}) > 1]
        if targets:
            for j, r in enumerate(spill):
                targets[j % len(targets)].append(r)
        else:
            groups.extend(same_host)
    if len(groups) > 1 and len(groups[-1]) == 1:
        groups[-2].extend(groups.pop())
    return [sorted(g) for g in groups]


def host_name() -> str:
    """This rank's host identity: ``HVT_TOPO_HOST`` (fakes a multi-host
    layout on one machine), else the launcher's ``HVT_HOSTNAME``, else the
    kernel's hostname."""
    return (os.environ.get("HVT_TOPO_HOST")
            or os.environ.get("HVT_HOSTNAME")
            or socket.gethostname())


class HvtCollectives:
    """The default collectives backend for :class:`ReplicatedState`: the
    port's ``allgather_object`` over a process set of each replication
    group. ``new_group`` is collective over the world, so :meth:`plan`
    registers every group of a plan on every rank, in the plan's order,
    before any group's allgather. Anything with ``rank``, ``size``,
    ``host`` and ``allgather`` can stand in (the tests' thread world
    does)."""

    def rank(self) -> int:
        return basics.rank()

    def size(self) -> int:
        return basics.size()

    def host(self) -> str:
        return host_name()

    def world(self):
        """Identifies the running world: a plan is kept only within it."""
        return id(basics._world())

    def plan(self, groups):
        from horovod_tpu_torch.common.process_sets import add_process_set

        for g in groups:
            if len(g) < basics.size():
                add_process_set(list(g))

    def allgather(self, obj, name: str, ranks=None) -> list:
        """One picklable object per member; returns the list ordered by
        member rank. ``ranks=None`` = the world; other ranks must be a
        group of the last :meth:`plan`."""
        from horovod_tpu_torch.common.process_sets import (add_process_set,
                                                           global_process_set)
        from horovod_tpu_torch.ops.functions import allgather_object

        ps = global_process_set
        if ranks is not None and len(ranks) < basics.size():
            ps = add_process_set(list(ranks))    # registered by plan()
        return allgather_object(obj, name=name, process_set=ps)


class ReplicatedState(ObjectState):
    """Checkpointless elastic state: :class:`ObjectState` whose
    ``commit()`` also refreshes versioned, CRC-stamped replica shards
    on K-1 peer ranks, and whose ``sync()`` rebuilds any rank's lost
    state from those peers instead of broadcasting blindly from rank 0.

    Life cycle under ``@hvt.elastic.run``:

    - ``commit()``: snapshot locally (base class), then allgather the
      pickled snapshot within this rank's replication group — after the
      call, K ranks on (topology permitting) K distinct hosts hold this
      rank's state at the committed version.
    - on failure: ``restore()`` rolls back locally exactly as before.
    - ``sync()`` (after re-rendezvous): the gang allgathers shard
      metadata; ranks whose state is missing or stale (fresh respawns)
      pull the newest intact shard for their owner id from a surviving
      replica via one allgather round; owner ids left unclaimed by a
      shrunken world are adopted deterministically and surface in
      :attr:`adopted` for the application to fold. A CRC-mismatched or
      missing replica falls back to ``fallback(self)`` when provided
      (application/checkpoint restore) and raises
      :class:`ReplicaUnavailableError` otherwise.

    ``owner`` is the rank's sticky identity: the rank it held when its
    state was first committed. Rank ids can shift across elastic rounds
    (the world shrinks); the owner id is what names a state lineage.

    Replication is on by default under ``HVT_STATE_REPLICATION`` and
    sized by ``HVT_REPLICA_GROUP_SIZE`` (K, default 2); commits stay
    off the hot path — nothing is exchanged until ``commit()`` runs.
    """

    def __init__(self, replicas=None, collectives=None, fallback=None,
                 **kwargs):
        self._replicas = replicas
        self._collectives = collectives
        self._fallback = fallback
        self._version = 0
        self._owner = None
        # owner -> [(version, shard blob)] newest-first, capped at TWO
        # generations: a host dying mid-commit leaves replication
        # groups skewed by one version (its own group's exchange
        # aborted, the others' completed), and the recovery cut is the
        # highest version EVERY lineage can produce — ranks past the
        # cut roll back one generation, which only works if the
        # previous generation still exists somewhere
        self._peer_shards = {}
        self._own_history = []   # [(version, payload)] newest-first
        self._groups_for = None  # the world the cached plan matches
        self._group = None
        self._adopted = {}       # orphaned owner -> decoded snapshot
        self._last_recovery = {}
        super().__init__(**kwargs)

    # ------------------------------------------------------------- plumbing
    @property
    def owner(self):
        return self._owner

    @property
    def version(self) -> int:
        return self._version

    @property
    def adopted(self) -> dict:
        """Snapshots of owner lineages orphaned by a shrunken world,
        adopted by this rank during the last ``sync()`` (deterministic
        assignment). The application decides how to fold them."""
        return self._adopted

    @property
    def last_recovery(self) -> dict:
        """``{phase, outcome, seconds, donor?}`` of the last sync."""
        return dict(self._last_recovery)

    def replica_info(self) -> dict:
        """Introspection for tests/debugz: group, versions held."""
        return {
            "owner": self._owner,
            "version": self._version,
            "group": list(self._group or ()),
            "held": {o: [v for v, _ in gens]
                     for o, gens in sorted(self._peer_shards.items())},
            "shard_bytes": self._shard_bytes(),
        }

    def _shard_bytes(self) -> int:
        return sum(len(b) for gens in self._peer_shards.values()
                   for _, b in gens)

    def _coll(self):
        if self._collectives is None:
            self._collectives = HvtCollectives()
        return self._collectives

    def _k(self) -> int:
        return self._replicas if self._replicas else replica_group_size()

    def _snapshot_payload(self) -> bytes:
        return pickle.dumps(self._saved_state, protocol=4)

    def _load_snapshot(self, payload: bytes, version: int):
        """One spelling of 'this payload is now my committed state'."""
        self._saved_state = pickle.loads(payload)
        self.restore()
        self._version = int(version)

    def _world_key(self):
        c = self._coll()
        world = getattr(c, "world", None)
        return (c.rank(), c.size(), world() if world else None)

    def _adopt_plan(self, groups):
        """Take ``groups`` (the same plan on every rank) as the current
        world's replication groups."""
        c = self._coll()
        plan = getattr(c, "plan", None)
        if plan is not None:
            plan(groups)
        self._group = next(g for g in groups if c.rank() in g)
        self._groups_for = self._world_key()

    def _plan_group(self):
        """This rank's replication group under the CURRENT world,
        computed from one gathered rank→host table and cached until the
        world identity changes (sync() resets the cache on re-init)."""
        c = self._coll()
        if self._groups_for == self._world_key() and self._group:
            return self._group
        table = c.allgather({"rank": c.rank(), "host": c.host()},
                            name="hvt.elastic.replica_plan")
        hosts_by_rank = [None] * c.size()
        for m in table:
            hosts_by_rank[int(m["rank"])] = m["host"]
        self._adopt_plan(build_replica_groups(hosts_by_rank, self._k()))
        return self._group

    def _ingest(self, blob):
        """Keep a peer shard iff it is intact and newer than what is
        already held for its owner (stale versions are rejected); the
        previous generation is retained — see the two-generation note in
        ``__init__``."""
        if not blob:
            return
        try:
            owner, version, _payload = decode_shard(bytes(blob))
        except ShardCorruptError:
            return  # a corrupt incoming copy never evicts a good one
        gens = self._peer_shards.setdefault(owner, [])
        if gens and version <= gens[0][0]:
            return
        gens.insert(0, (version, bytes(blob)))
        del gens[2:]

    def _held_blob(self, owner, version):
        for v, blob in self._peer_shards.get(owner, ()):
            if v == version:
                return blob
        return None

    # ------------------------------------------------------------ commit
    def commit(self):
        raise_if_aborted()
        self.save()
        if replication_enabled():
            self._replicate()
        self.check_host_updates()

    def _replicate(self):
        """Refresh this rank's shard on its group peers (and ingest
        theirs) — one object allgather on the group's process-set
        lane."""
        c = self._coll()
        if self._owner is None:
            self._owner = c.rank()
        payload = self._snapshot_payload()
        self._version += 1
        self._own_history.insert(0, (self._version, payload))
        del self._own_history[2:]
        if c.size() <= 1:
            return
        group = self._plan_group()
        blob = encode_shard(self._owner, self._version, payload)
        gi = min(group)
        shards = c.allgather(blob, name=f"hvt.elastic.replicate.g{gi}",
                             ranks=group)
        for member, peer_blob in zip(group, shards):
            if member != c.rank():
                self._ingest(peer_blob)
        # our own committed copy rides in _own_history; hold the framed
        # shard too so a donor lookup is uniform across owners
        self._ingest(blob)

    # -------------------------------------------------------------- sync
    def sync(self):
        """Gang-wide state recovery after a re-initialization. See the
        class docstring for the full decision flow; every collective
        here runs on the WORLD set (the membership just changed — group
        lanes are re-planned afterwards)."""
        import time as _time

        if not replication_enabled():
            self._bootstrap_sync()
            return
        t0 = _time.monotonic()
        c = self._coll()
        self._groups_for = None  # world changed: re-plan groups lazily
        self._adopted = {}
        me = c.rank()
        meta = {"rank": me, "owner": self._owner,
                "version": self._version, "host": c.host(),
                "held": {o: [v for v, _ in gens]
                         for o, gens in self._peer_shards.items()}}
        metas = c.allgather(meta, name="hvt.elastic.replica_meta")
        metas.sort(key=lambda m: int(m["rank"]))
        # the meta exchange already carries the rank→host table — plan
        # the new world's replication groups from it now, so the
        # post-rebuild re-replication skips its own plan allgather
        # (two fewer gang collectives on the recovery path)
        try:
            hosts_by_rank = [m.get("host") or "?" for m in metas]
            self._adopt_plan(build_replica_groups(hosts_by_rank,
                                                  self._k()))
        except (StopIteration, ValueError):
            self._groups_for = None  # re-plan lazily on next commit

        # versions available per owner lineage: owner -> {version:
        # [holder ranks]}
        available = {}
        for m in metas:
            for o, versions in (m.get("held") or {}).items():
                for v in versions:
                    o, v = int(o), int(v)
                    if v > 0:
                        available.setdefault(o, {}).setdefault(
                            v, []).append(int(m["rank"]))
        # the recovery cut: the highest version EVERY lineage can still
        # produce. A host dying mid-commit leaves groups one version
        # apart; ranks past the cut roll back a generation (held for
        # exactly this), so the gang resumes from one consistent step.
        target = min((max(vs) for vs in available.values()), default=0)
        if target <= 0:
            # nothing committed anywhere yet (initial round): plain
            # broadcast-from-rank-0 semantics
            self._bootstrap_sync()
            self._last_recovery = {"phase": "bootstrap_sync",
                                   "outcome": "ok"}
            return

        claimed = {int(m["owner"]) for m in metas
                   if m.get("owner") is not None}
        orphans = sorted(o for o in available if o not in claimed)
        fresh = sorted(int(m["rank"]) for m in metas
                       if m.get("owner") is None)
        # fresh respawns adopt unclaimed lineages first (a replacement
        # worker takes over the dead rank's state), deterministically;
        # fresh ranks beyond the orphan supply start BRAND-NEW
        # lineages with ids past every known owner — defaulting to the
        # rank id would collide with a survivor whose sticky owner
        # happens to equal this rank after a shrink
        adoption = dict(zip(fresh, orphans))
        next_id = max(set(available) | claimed | {-1}) + 1
        for i, r in enumerate(fresh[len(orphans):]):
            adoption[r] = next_id + i
        my_owner = self._owner if self._owner is not None \
            else adoption.get(me, me)
        # lineages still orphaned after respawns are adopted by live
        # members round-robin so a shrunken world loses no state
        leftovers = orphans[len(fresh):]
        ranks_sorted = sorted(int(m["rank"]) for m in metas)
        my_adoptions = [o for i, o in enumerate(leftovers)
                        if ranks_sorted[i % len(ranks_sorted)] == me]

        # which lineages must move at all: a rank serves its own owner
        # locally when it holds (owner, target); anything else — fresh
        # adopters, rolled-past ranks whose predecessor generation only
        # survives on a peer, leftover orphans — rides ONE gang
        # allgather, each shard contributed by its designated donor
        # (lowest holder rank)
        boot = min(available)  # bootstrap source for brand-new lineages
        need = set(leftovers)
        for m in metas:
            o = m["owner"] if m.get("owner") is not None \
                else adoption.get(int(m["rank"]))
            if o is None or int(o) not in available:
                # grown world: a rank starting a brand-new lineage
                # copies the cut-version state of the lowest lineage
                # (classic new-worker bootstrap, replica-served)
                need.add(boot)
                continue
            held = m.get("held") or {}
            if target not in held.get(o, held.get(str(o), [])):
                need.add(int(o))
        serving = {}
        for o in sorted(need):
            holders = available.get(o, {}).get(target, [])
            if holders and min(holders) == me:
                blob = self._held_blob(o, target)
                if blob is not None:
                    serving[o] = blob
        gathered = c.allgather(serving, name="hvt.elastic.replica_fill")
        fills = {}
        for contribution in gathered:
            for o, blob in (contribution or {}).items():
                fills.setdefault(int(o), bytes(blob))

        outcome, settle_err = "ok", None
        if self._version != target:
            try:
                if my_owner in available:
                    outcome = self._settle_own(my_owner, target,
                                               fills.get(my_owner))
                else:
                    outcome = self._settle_own(my_owner, target,
                                               fills.get(boot),
                                               bootstrap=True)
            except ReplicaUnavailableError as e:
                outcome, settle_err = "failed", e
        # gang-wide consensus on outcomes: a rank whose lineage is
        # unrecoverable AND has no fallback fails the whole gang (any
        # recovery the survivors kept would sit at a cut that rank can
        # never reach). A rank that DID restore from its application
        # fallback no longer drags the rest of the gang with it: with
        # HVT_PARTIAL_FALLBACK (default on) the intact lineages keep
        # their peer-rebuilt state at the cut and only the lost
        # lineages pay the checkpoint — per-lineage blast radius
        # instead of all-or-nothing. HVT_PARTIAL_FALLBACK=0
        # restores the old gang-wide semantics for gang-replicated
        # application state (see partial_fallback_enabled).
        outs = c.allgather(outcome,
                           name="hvt.elastic.replica_outcome")
        if any(o == "failed" for o in outs):
            self._last_recovery = {"phase": "rebuild",
                                   "outcome": "failed",
                                   "version": target}
            raise settle_err if settle_err is not None else \
                ReplicaUnavailableError(
                    f"peer rank(s) "
                    f"{[i for i, o in enumerate(outs) if o == 'failed']} "
                    f"hold unrecoverable lineages; gang-wide fallback "
                    f"to application restore")
        fellback = [i for i, o in enumerate(outs) if o == "fallback"]
        if fellback and outcome != "fallback" and \
                not partial_fallback_enabled():
            if self._fallback is None:
                self._last_recovery = {"phase": "rebuild",
                                       "outcome": "failed",
                                       "version": target}
                raise ReplicaUnavailableError(
                    "a peer restored from its application fallback; "
                    "this rank has none to match the gang's cut "
                    "(HVT_PARTIAL_FALLBACK=0)")
            self._fallback(self)
            self.save()
            self._version = target
            self._own_history = [(target, self._snapshot_payload())]
            outcome = "fallback"
        self._owner = my_owner
        orphans_lost = []
        for o in my_adoptions:
            blob = fills.get(o) or self._held_blob(o, target)
            try:
                if blob is None:
                    raise ShardCorruptError("no intact shard gathered")
                _owner, _v, payload = decode_shard(blob)
                self._adopted[o] = pickle.loads(payload)
            except ShardCorruptError:
                # best-effort by design (the gang must not fall back
                # wholesale over a lineage nobody is training), but
                # NEVER silent: the lineage's shards are about to be
                # retired below, so this is the moment its state is
                # actually lost
                orphans_lost.append(int(o))
        # drop shard generations past the cut everywhere (aborted
        # futures — version numbers are about to be reused by the
        # resumed trajectory), and RETIRE the leftover-adopted orphan
        # lineages entirely: their live data now rides inside the
        # adopter's own snapshot, and a frozen shard lingering in the
        # store would drag a FUTURE sync's recovery cut down to its
        # ancient version, failing the whole gang over state nobody
        # needs
        for o, gens in list(self._peer_shards.items()):
            kept = [] if o in leftovers else \
                [(v, b) for v, b in gens if v <= target]
            if kept:
                self._peer_shards[o] = kept[:2]
            else:
                del self._peer_shards[o]
        self._own_history = [(v, p) for v, p in self._own_history
                             if v <= target]
        self.save()
        dt = _time.monotonic() - t0
        self._last_recovery = {"phase": "rebuild", "outcome": outcome,
                               "version": target,
                               "seconds": round(dt, 4)}
        if orphans_lost:
            self._last_recovery["orphans_lost"] = orphans_lost
        if fellback:
            # which ranks restored their lineage from the application
            # fallback this round — the per-lineage recovery record
            # (the partial-loss tests read it)
            self._last_recovery["fallback_ranks"] = sorted(fellback)
        # close the vulnerability window: re-replicate at the recovered
        # version so the gang is back at full replication factor before
        # training resumes (also re-plans groups for the new world)
        if c.size() > 1:
            self._replicate()

    def _bootstrap_sync(self):
        """Pre-first-commit sync: everyone takes rank 0's attributes
        (classic elastic semantics). Uses the injected backend when one
        is present (the tests' thread world has no process group)."""
        if isinstance(self._coll(), HvtCollectives):
            super().sync()
            return
        c = self._coll()
        gathered = c.allgather(
            self._tracked() if c.rank() == 0 else None,
            name="hvt.elastic.bootstrap")
        for k, v in (gathered[0] or {}).items():
            setattr(self, k, v)
        self.save()

    def _settle_own(self, owner, target, blob, bootstrap=False):
        """Bring this rank's own lineage to the recovery cut: roll back
        a generation when it ran past the cut, rebuild from the
        gathered peer shard when it is behind (fresh respawn / adopted
        lineage), bootstrap-copy a peer lineage when this one never
        committed (grown world), and on a missing or corrupt replica
        fall back to the application restore."""
        if self._version > target:
            for v, payload in self._own_history:
                if v == target:
                    self._load_snapshot(payload, target)
                    return "rollback"
        if blob is None and not bootstrap:
            blob = self._held_blob(owner, target)
        if blob is not None:
            try:
                _o, v, payload = decode_shard(blob)
                if v == target:
                    self._load_snapshot(payload, target)
                    self._own_history = [(target, payload)]
                    if not bootstrap:
                        self._ingest(blob)
                    outcome = "bootstrap" if bootstrap else "peer"
                    return outcome
            except ShardCorruptError:
                pass
        if self._fallback is not None:
            self._fallback(self)
            self.save()
            self._version = target
            self._own_history = [(target, self._snapshot_payload())]
            return "fallback"
        raise ReplicaUnavailableError(
            f"no intact replica for owner {owner} at version "
            f"{target} and no application fallback was provided")
