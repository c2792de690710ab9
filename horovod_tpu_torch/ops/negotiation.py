"""The coordinator's checks on the eager collectives: the port's
counterpart of the JAX engine's negotiation (``horovod_tpu/csrc/engine.cc``:
``BuildResponse`` ``:2284``, the stall inspector ``CheckStalls`` ``:2472``
and the cross-set conflict check ``:1844``).

Before an eager collective moves data over a set of more than one process
(outside CUDA-graph capture), each member posts its request: the tensor's
name, op, dtypes and shapes, reduce op or root, pre- and postscale, fusion
group id and size, and an alltoall's splits. Every member reads every
member's request and checks them in the engine's order, so every member
reaches the same verdict without a second round. Where they disagree, every
member raises the ``ValueError`` the engine raises for the same program,
with its text ("mismatched shape for tensor 'x' ([3] vs [2])"; an
allgather or alltoall compares only the number of dims and the dims after
the first), before any data moves, and the set's later collectives work. A
grouped allreduce is one request for the whole group, so one bad member
fails the group ("... (fusion group 1 aborted)").

Two transports carry the requests:

- *The board*, when every process of the world maps the same file (one
  host): a ring of records a rank and a set, in shared memory. A member
  writes its request's digest (a BLAKE2b hash of the request, without an
  allgather's rows, which go beside it) at its position and polls the
  other members' records; equal digests are agreement, and nothing goes
  through the store. A digest that differs sends every member to the
  store, where each posts its request in full and the check runs on the
  full requests. The sets with ids below ``_BOARD_SETS`` use it. A rank
  may have posted at most ``WINDOW`` positions of a set that it has not
  read (``collective_ops`` issues the oldest first), so a ring's record is
  read by every member before it is written again.
- *The process group's TCP store*, for a world across hosts and the other
  sets: each member posts its request under ``hvt_neg/`` and reads every
  member's with one blocking read. Once every member has read ``_SWEEP``
  positions, each deletes its records there, so the store holds only the
  positions in flight and the last few read.

Requests are paired by call order on each set, not by name: the k-th
collective a member calls on a set is compared with the k-th of every other
member. Members whose names differ at one position wait, as two blocking
calls of different names wait in the engine, and the stall inspector names
them. Async collectives are negotiated when they are called, so ranks that
submit async collectives in different orders are not reordered, as the
engine would reorder them. Unnamed calls get the engine's default names,
``hvt.<op>.<n>``, with ``n`` counted per process set. A set that holds every
rank is the global set.

Ranks that pass overlapping but different sets for the same tensor name
([0,1,2] against [1,2,3]) can never complete either negotiation: once every
member of every such set has posted the name, each raises "tensor 't' was
submitted with conflicting process sets across ranks", the first to see it
records the verdict for the others, and each set's position moves on on all
of its members; a disjoint set that reuses the name is spared.

The stall inspector is a thread of each process. The lowest rank of a set
warns once per tensor, with the engine's text, when some members have
posted a request that others have not posted for ``HVT_STALL_WARN_SEC``
(default 60; ``launch --stall-warning-sec``): ranks inside ``join()`` are
never named missing. A request that has waited ``_SLOW_SEC`` on the board
is posted to the store too, where the inspector reads it. It counts the
warnings in ``hvt_engine_stalls_total``, sets
``hvt_stall_missing_ranks{tensor}`` and keeps the ``negotiations`` and
``stalls`` tables of ``diagnostics()``. The same thread writes a heartbeat,
deletes the store keys that every member has read, and watches the reads
that wait: it ends one when a missing peer's heartbeat stopped for
``_DEAD_SEC`` (the peer died) or the world was aborted (``basics.abort``
ends them at once), raising ``HorovodInternalError``, and with the
conflict's error when the sets conflict. A read of the store ends on every
member waiting there (a stand-in record for each missing member); a wait on
the board is ended by each member's own inspector. The process group's
timeout and a store that is gone raise ``HorovodInternalError`` too. The
state resets at every ``basics.init``.

With a timeline recording, each negotiated collective writes on the lane
``<tensor> (coordinator)``: ``ENQUEUED``, the exec span (the op's name,
from issue to wait), and ``DONE`` or ``ERROR``; the set's lowest rank also
writes ``NEGOTIATE_<OP>`` from the first member's arrival to its own read,
with a ``RANK_READY_<r>`` instant at each member's arrival, which
``tools/hvt_analyze.py`` reads for its phases and straggler ranking.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import mmap
import os
import secrets
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta

import numpy as np
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.utils import timeline

_PREFIX = "hvt_neg/"
_SLOW_SEC = 0.1         # a request waiting this long goes to the store too
_WATCH_SEC = 0.1        # the inspector's period
_HEARTBEAT_SEC = 0.5
_DEAD_SEC = 5.0         # a heartbeat this old means the peer is gone
_POLL_SEC = 0.02
_INSPECT_TIMEOUT = timedelta(seconds=2)     # the inspector's store reads
_LANE = " (coordinator)"

# a request: (names, op, dtypes, shapes, reduce, root, prescale,
# postscale, group id, group size, splits); one entry of names, dtypes and
# shapes per tensor, several for a grouped allreduce
NAMES, OP, DTYPES, SHAPES, REDUCE, ROOT, PRE, POST, GID, GSIZE, SPLITS = \
    range(11)
_ROWS_FREE = ("allgather", "alltoall")   # dim 0 may differ by rank

# the board: process sets with ids below _BOARD_SETS, a ring of _SLOTS
# records per set and rank; a record is (position, digest (2 words),
# arrival in µs of the wall clock, an allgather's rows, check word)
_BOARD_SETS = 16
_SLOTS = 512
WINDOW = _SLOTS // 2    # positions of a set posted and not yet read
_POS, _D0, _D1, _T_US, _AUX, _CHK = range(6)
_WORDS = 6
_JOIN = -1              # both digest words: the member is inside join()
_MAGIC = 0x5BD1E9955BD1E995
_TOKEN = 16             # bytes of the file's token, before the rings
_AGREED = 1024          # the engine's default cache capacity
_SWEEP = 64             # store positions deleted at a time


def _dims(shape) -> str:
    return "[" + ",".join(str(d) for d in shape) + "]"


def check(reqs):
    """The engine's cross-rank checks (``BuildResponse``) over ``reqs``,
    the requests in the engine's order: the error text, or None when they
    agree. Member i of a grouped request is checked as the engine checks
    its i-th negotiation."""
    a = reqs[0]
    for i, name in enumerate(a[NAMES]):
        for q in reqs:
            why = _check_one(a, q, i, name)
            if why is not None:
                if a[GID] >= 0:
                    why += f" (fusion group {a[GID]} aborted)"
                return why
    return None


def _check_one(a, q, i, name):
    if q[OP] != a[OP]:
        return f"mismatched collective op for tensor '{name}'"
    if q[DTYPES][i] != a[DTYPES][i]:
        return f"mismatched dtype for tensor '{name}'"
    if q[REDUCE] != a[REDUCE]:
        return f"mismatched reduce op for tensor '{name}'"
    if q[ROOT] != a[ROOT]:
        return f"mismatched root rank for tensor '{name}'"
    if q[PRE] != a[PRE] or q[POST] != a[POST]:
        return f"mismatched scale factors for tensor '{name}'"
    if q[GID] != a[GID] or q[GSIZE] != a[GSIZE]:
        return (f"mismatched fusion group for tensor '{name}' (all ranks "
                "must submit grouped collectives with identical membership)")
    qs, as_ = q[SHAPES][i], a[SHAPES][i]
    if a[OP] in _ROWS_FREE:
        if len(qs) != len(as_):
            return f"mismatched rank (ndims) for tensor '{name}'"
        if qs[1:] != as_[1:]:
            return f"mismatched non-leading dims for tensor '{name}'"
    elif qs != as_:
        return (f"mismatched shape for tensor '{name}' ({_dims(qs)} vs "
                f"{_dims(as_)})")
    return None


def _from_json(v):
    """A request back from its JSON lists."""
    return (tuple(v[NAMES]), v[OP], tuple(v[DTYPES]),
            tuple(tuple(s) for s in v[SHAPES]), v[REDUCE], v[ROOT], v[PRE],
            v[POST], v[GID], v[GSIZE],
            None if v[SPLITS] is None else tuple(v[SPLITS]))


_digests = {}       # request without its rows -> its two digest words


def digest(req):
    """The board's two words for ``req``: a BLAKE2b hash of the request
    whose dim 0 and splits are left out where they may differ by rank (an
    allgather, an alltoall), so equal words are agreement."""
    if req[OP] in _ROWS_FREE:
        req = req[:SHAPES] + (tuple((-1,) + tuple(s[1:]) if s else s
                                    for s in req[SHAPES]),) + \
            req[SHAPES + 1:SPLITS] + (None,)
    words = _digests.get(req)
    if words is None:
        h = hashlib.blake2b(json.dumps(req).encode(), digest_size=16).digest()
        words = (int.from_bytes(h[:8], "little", signed=True),
                 int.from_bytes(h[8:], "little", signed=True))
        if words == (_JOIN, _JOIN):
            words = (_JOIN, 0)
        if len(_digests) >= 4096:
            _digests.clear()
        _digests[req] = words
    return words


class _Board:
    """The board's file, mapped: ``ring[set, rank, k % _SLOTS]`` is the
    rank's record of position k on the set, and ``done[set, rank]`` the next
    position the rank reads there."""

    def __init__(self, path, size):
        ring = _BOARD_SETS * size * _SLOTS * _WORDS * 8
        fd = os.open(path, os.O_RDWR)
        try:
            self.mm = mmap.mmap(fd, self.nbytes(size))
        finally:
            os.close(fd)
        self.token = bytes(self.mm[:_TOKEN])
        self.ring = np.ndarray((_BOARD_SETS, size, _SLOTS, _WORDS),
                               np.int64, self.mm, _TOKEN)
        self.done = np.ndarray((_BOARD_SETS, size), np.int64, self.mm,
                               _TOKEN + ring)

    @staticmethod
    def nbytes(size):
        return _TOKEN + _BOARD_SETS * size * (_SLOTS * _WORDS + 1) * 8

    def write(self, s, rank, k, words, aux):
        row = self.ring[s, rank, k % _SLOTS]
        t_us = int(time.time() * 1e6)
        row[_D0], row[_D1], row[_T_US], row[_AUX] = words[0], words[1], \
            t_us, aux
        row[_CHK] = k ^ words[0] ^ words[1] ^ t_us ^ aux ^ _MAGIC
        row[_POS] = k       # last: the record is there

    def read(self, s, members, k):
        """Every member's record at position k (``members`` None for every
        rank), and which are there: written for k and whole (the check
        word matches)."""
        i = k % _SLOTS
        a = (self.ring[s, :, i] if members is None else
             self.ring[s, members, i]).tolist()
        return a, [r[_POS] == k and r[_CHK] == r[_POS] ^ r[_D0] ^ r[_D1] ^
                   r[_T_US] ^ r[_AUX] ^ _MAGIC for r in a]


class Outcome:
    """What a negotiation agreed on: each member's request in the set's
    order (None for a rank inside ``join()``), and where its timeline
    events go (a set of one process has the lane alone). ``rows`` is
    every member's dim 0 where the board carried them (an allgather)."""

    __slots__ = ("reqs", "joins", "index", "lane", "lane_id", "_rows")

    def __init__(self, reqs, joins, index, lane, lane_id, rows=None):
        self.reqs, self.joins, self.index = reqs, joins, index
        self.lane, self.lane_id, self._rows = lane, lane_id, rows

    @property
    def negotiated(self) -> bool:
        """False for a set of one process (:func:`local`)."""
        return self.reqs is not None

    def active(self):
        """The first request of a rank not inside ``join()``."""
        return next(q for q in self.reqs if q is not None)

    def rows(self):
        """Every member's dim 0 (an allgather); 0 for a joined rank."""
        if self._rows is not None:
            return self._rows
        return [q[SHAPES][0][0] if q is not None else 0 for q in self.reqs]

    def recv_splits(self):
        """The rows every member sends here (an alltoall); 0 from a joined
        rank."""
        return [q[SPLITS][self.index] if q is not None else 0
                for q in self.reqs]


class _Set:
    """This process's negotiation state on one process set; ``board`` is
    its index on the board, or None where it negotiates in the store."""

    def __init__(self, key, members, board=None):
        self.key, self.members = key, tuple(members)
        self.board = board
        # the rows of its members on the board (None: every rank's)
        self.on_board = list(self.members)
        self.pos = 0            # the next position this rank posts at
        self.done_pos = 0       # the next position this rank reads
        self.names = 0          # unnamed tensors so far (their names)
        self.groups = 0         # grouped calls so far (their ids)
        # the last request agreed on under each name, the most recent
        # _AGREED: a request equal to one is the engine's cache hit, which
        # the engine checks after the requests that are not
        self.agreed = {}
        self.said = 0           # store: positions up to here counted read
        self.swept = 0          # ... and this rank's records there deleted
        self.verdicts = []      # store: positions that got a verdict

    def agree(self, req):
        names = req[NAMES]
        self.agreed.pop(names, None)
        self.agreed[names] = req
        if len(self.agreed) > _AGREED:
            del self.agreed[next(iter(self.agreed))]


class Ticket:
    """A request posted at one position of a set and not read yet.
    ``on_board`` while its read polls the board; ``ended`` is what ended
    that poll (kind, text); ``posted`` once its record is in the store."""

    __slots__ = ("st", "k", "req", "keys", "lane", "name", "me", "wall",
                 "payload", "words", "on_board", "ended", "posted")

    def __init__(self, st, k, req, keys, lane):
        self.st, self.k, self.req, self.keys, self.lane = st, k, req, keys, \
            lane
        self.name = req[NAMES][0] if req is not None else None
        self.wall, self.payload, self.words = time.time(), None, None
        self.on_board, self.ended, self.posted = False, None, False
        self.me = 0


class _Coordinator:
    def __init__(self, store, rank, size, timeout_s):
        self.master = store     # keeps rank 0's store server alive
        self.tcp = store
        while not isinstance(self.tcp, dist.TCPStore):
            self.tcp = self.tcp.underlying_store
        self.rank, self.size, self.timeout_s = rank, size, timeout_s
        self.local = threading.local()
        self.lock = threading.Lock()
        self.sets = {}
        self.warn_sec = float(os.environ.get("HVT_STALL_WARN_SEC") or 60)
        self.warned = set()
        self.waiting = {}       # Ticket -> [read start, c/<rank> posted]
        self.open = {}          # board Ticket -> post time, until read
        self.table = {}         # (set, k, tensor) -> a negotiation row
        self.posted = []        # board positions' store keys to delete
        #                         once every member read past: (set, k,
        #                         members, keys)
        self.board = self._open_board()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._inspect, daemon=True,
                                       name="hvt-stall-inspector")
        self.thread.start()

    # ------------------------------------------------------------ store
    def _client(self, timeout):
        if hasattr(self.tcp, "clone"):
            client = self.tcp.clone()
            client.set_timeout(timeout)
        else:
            client = dist.TCPStore(self.tcp.host, self.tcp.port,
                                   is_master=False, timeout=timeout)
        return dist.PrefixStore(_PREFIX, client)

    def store(self):
        """This thread's own client of the store, so that its reads never
        queue behind another thread's."""
        s = getattr(self.local, "store", None)
        if s is None:
            s = self.local.store = self._client(
                timedelta(seconds=self.timeout_s))
        return s

    def _open_board(self):
        """The board, when every process maps the same file: rank 0 makes
        it in the temporary directory and names it in the store with a
        token, each rank says whether it mapped that file, and rank 0
        unlinks it once every rank has said. None where one could not."""
        store = self.store()
        if self.rank == 0:
            token, path = secrets.token_hex(_TOKEN // 2), ""
            try:
                fd, path = tempfile.mkstemp(prefix="hvt_board_")
                try:
                    os.ftruncate(fd, _Board.nbytes(self.size))
                    os.pwrite(fd, token.encode(), 0)
                finally:
                    os.close(fd)
            except OSError:
                pass        # no board: every set negotiates in the store
            store.set("board", json.dumps([path, token]))
        path, token = json.loads(store.get("board"))
        board = None
        try:
            b = _Board(path, self.size)
            board = b if b.token == token.encode() else None
        except (OSError, ValueError):
            pass
        store.set(f"board/{self.rank}", "1" if board is not None else "0")
        said = store.multi_get([f"board/{r}" for r in range(self.size)])
        if self.rank == 0 and path:
            os.unlink(path)
        return board if all(v == b"1" for v in said) else None

    def set_state(self, process_set):
        ranks = process_set.global_ranks()
        key = "0" if len(ranks) == self.size else \
            str(process_set.process_set_id)
        return self.set_for(key, ranks)

    def set_for(self, key, members):
        with self.lock:
            st = self.sets.get(key)
            if st is None:
                st = self.sets[key] = _Set(key, members,
                                           self._board_index(key))
                if st.members == tuple(range(self.size)):
                    st.on_board = None
            return st

    def _board_index(self, key):
        """The set's index on the board, or None (no board, or an id past
        the board's sets)."""
        index = int(key)
        return index if self.board is not None and index < _BOARD_SETS \
            else None

    # -------------------------------------------------------- negotiate
    def post(self, st, req, joined=None) -> Ticket:
        """Post this rank's request (or, inside ``join()``, the join record
        ``joined``) at the set's next position."""
        k = st.pos
        st.pos = k + 1
        lane = None
        if req is not None and timeline.active():
            lane = req[NAMES][0] + _LANE
            timeline.instant(lane, "ENQUEUED", args={"lane": int(st.key)})
        t = Ticket(st, k, req, [f"r/{st.key}/{k}/{m}" for m in st.members],
                   lane)
        t.me = st.members.index(self.rank)
        t.payload = "J" + json.dumps(joined) if joined is not None else None
        if st.board is None:
            self._post_record(t)
            return t
        if joined is not None:
            t.words, rows = (_JOIN, _JOIN), 0
        else:
            t.words = digest(req)
            rows = req[SHAPES][0][0] if req[OP] == "allgather" else 0
        self.board.write(st.board, self.rank, k, t.words, rows)
        if joined is not None or req[OP] == "alltoall":
            self._post_record(t)    # read from the store: the splits
        else:
            self.open[t] = time.monotonic()
        return t

    def _post_record(self, t, store=None):
        """Post the ticket's record in the store: its post time on the wall
        clock and its request (or join record)."""
        if t.posted:
            return
        t.posted = True
        if t.payload is None:
            t.payload = json.dumps(t.req)
        self._store_op(t, lambda s: s.set(
            t.keys[t.me], f"{t.wall:.6f} {t.payload}"), store)
        if t.st.board is not None:
            with self.lock:
                self.posted.append((t.st.board, t.k, t.st.members,
                                    [t.keys[t.me]]))

    def ready(self, t, verdicts) -> bool:
        """Whether :meth:`finish` would find every member's record (or,
        with ``verdicts``, a conflict's verdict) at once."""
        if self._board_read(t):
            a, there = self.board.read(t.st.board, t.st.on_board, t.k)
            if all(there) or self._differs(t, a, there):
                return True
        elif self._store_op(t, lambda s: s.check(t.keys)):
            return True
        return bool(verdicts) and self._store_op(
            t, lambda s: s.check([f"v/{t.st.key}/{t.k}"]))

    def _board_read(self, t) -> bool:
        """Whether the ticket is read from the board (else the store)."""
        return t.st.board is not None and t.req is not None and \
            t.req[OP] != "alltoall"

    @staticmethod
    def _differs(t, a, there) -> bool:
        """Whether a member's record is there and disagrees with this
        rank's."""
        w0, w1 = t.words
        return any(ok and (r[_D0], r[_D1]) not in ((w0, w1), (_JOIN, _JOIN))
                   for r, ok in zip(a, there))

    def _store_op(self, t, fn, store=None):
        try:
            return fn(self.store() if store is None else store)
        except HorovodInternalError:
            raise
        except RuntimeError as e:
            raise HorovodInternalError(f"negotiation of '{t.name}' failed: "
                                       f"{e}") from e

    def finish(self, t) -> Outcome:
        """Wait for every member's record at the ticket's position and
        return them, checked; raises the engine's ``ValueError`` where they
        disagree. Tickets of a set are finished in the order posted."""
        try:
            if self._board_read(t):
                out = self._finish_board(t)
                if out is not None:
                    return out
            return self._finish_store(t)
        finally:
            self.open.pop(t, None)
            self._read(t.st, t.k)

    def _read(self, st, k):
        """This rank has read position k of the set."""
        st.done_pos = max(st.done_pos, k + 1)
        if st.board is not None:
            self.board.done[st.board, self.rank] = st.done_pos

    def _finish_board(self, t):
        """Poll the board until every member's record is at the ticket's
        position: the :class:`Outcome` where they agree, None where one
        differs (the ticket's record is then in the store, for
        :meth:`_finish_store`)."""
        st = t.st
        entry = self.waiting[t] = [time.monotonic(), False]
        t.on_board = True
        polls = 0
        try:
            while True:
                a, there = self.board.read(st.board, st.on_board, t.k)
                if self._differs(t, a, there):
                    t.on_board = False
                    self._post_record(t)
                    return None
                if all(there):
                    return self._board_outcome(t, a)
                if t.ended is not None:
                    kind, text = t.ended
                    self._done(t.lane, error=True)
                    if kind == "verdict":
                        raise ValueError(self._adopt(self._store_op(
                            t, lambda s: s.get(f"v/{st.key}/{t.k}"))))
                    raise HorovodInternalError(text)
                polls += 1
                if polls > 32:      # spin first, then sleep up to 200 µs
                    time.sleep(min(2e-4, 1e-5 * (polls - 32)))
        finally:
            t.on_board = False
            del self.waiting[t]
            if entry[1]:
                self._store_op(t, lambda s: s.delete_key(f"c/{self.rank}"))

    def _board_outcome(self, t, a):
        st = t.st
        joined = [r[_D0] == _JOIN and r[_D1] == _JOIN for r in a]
        if any(joined):
            self._post_record(t)    # the joined ranks read the request
        reqs = [None if j else t.req for j in joined]
        st.agree(t.req)
        rows = None
        if t.req[OP] == "allgather":
            rows = [0 if j else r[_AUX] for j, r in zip(joined, a)]
        if t.me == 0 and t.lane is not None:
            offset = timeline.clock_offset_us()
            self._timeline(t, [r[_T_US] + offset for r in a], reqs)
        return Outcome(reqs, [None] * len(reqs), t.me, t.lane, int(st.key),
                       rows)

    def _timeline(self, t, ts, reqs):
        """The set's lowest rank's ``NEGOTIATE_<OP>`` span and each active
        member's arrival (``ts``, on the timeline's clock)."""
        active = [x for x, q in zip(ts, reqs) if q is not None]
        timeline.negotiate_start(t.lane, t.req[OP].upper(), ts=min(active))
        for m, x, q in zip(t.st.members, ts, reqs):
            if q is not None:
                timeline.rank_ready(t.lane, m, ts=x)
        timeline.negotiate_end(t.lane, op_name=t.req[OP].upper())

    def _finish_store(self, t) -> Outcome:
        st, req, lane = t.st, t.req, t.lane
        recs = self._store_op(t, lambda s: self._gather(s, t))
        if isinstance(recs, str):       # a conflict's verdict
            self._done(lane, error=True)
            raise ValueError(recs)
        reqs, joins, ts = self._decode(recs)
        if t.me == 0 and req is not None and lane is not None:
            self._timeline(t, ts, reqs)
        active = [q for q in reqs if q is not None]
        if active:
            hit = st.agreed.get(active[0][NAMES])
            why = check([q for q in active if q != hit] +
                        [q for q in active if q == hit])
            if why is not None:
                self._done(lane, error=True)
                raise ValueError(why)
            st.agree(active[0])
        return Outcome(reqs, joins, t.me, lane, int(st.key))

    def _decode(self, recs):
        """Every member's request (None for a joined rank) and join record
        (None for an active one), and each member's arrival on the
        timeline's clock."""
        reqs, joins, ts = [], [], []
        for raw in recs:
            t_wall, payload = raw.decode().split(" ", 1)
            # on this rank's timeline clock: the members' wall clocks are
            # one clock on one host, where each rank's measured offset to
            # the launcher's clock only adds its error
            ts.append(float(t_wall) * 1e6 + timeline.clock_offset_us())
            if payload[0] == "J":
                joins.append(json.loads(payload[1:]))
                reqs.append(None)
            else:
                joins.append(None)
                reqs.append(_from_json(json.loads(payload)))
        names = {q[NAMES] for q in reqs if q is not None}
        if len(names) > 1:
            raise _NamesDiffer(names)
        return reqs, joins, ts

    def _done(self, lane, error=False):
        if lane is not None:
            timeline.instant(lane, "ERROR" if error else "DONE")

    def _gather(self, store, t):
        """Every member's record at the ticket's position, once all are
        posted, or a conflict verdict's error text. One blocking read,
        which the store answers as the last record arrives (under the
        store's own timeout, the process group's); a timed read that
        expires makes torch log a warning, and polling costs round trips.
        The inspector thread watches a read that waits (:meth:`_watch`)
        and ends it, by posting a stand-in record for each missing member,
        when the world is aborted, a missing member's heartbeat stopped, or
        the sets conflict."""
        entry = self.waiting[t] = [time.monotonic(), False]
        try:
            recs = store.multi_get(t.keys)
        finally:
            del self.waiting[t]
        if entry[1]:        # the inspector said what this rank waits on
            store.delete_key(f"c/{self.rank}")
        for raw in recs:
            if raw[:1] == b"X":
                why = json.loads(raw[2:])
                if why["kind"] == "verdict":
                    return self._adopt(store.get(f"v/{t.st.key}/{t.k}"))
                raise HorovodInternalError(why["text"])
        return recs

    def _missing(self, store, t):
        """The members whose record at the ticket's position is not
        there."""
        if t.on_board:
            _, there = self.board.read(t.st.board, t.st.on_board, t.k)
            return [m for m, ok in zip(t.st.members, there) if not ok]
        return [m for m, key in zip(t.st.members, t.keys)
                if not store.check([key])]

    def _watch(self, store):
        """The inspector's look at the board's requests that wait (each
        goes to the store after ``_SLOW_SEC``) and at each read that has
        waited ``_SLOW_SEC``: say what this rank waits on (``c/<rank>``,
        which the conflict check reads), and end the read for an abort, a
        verdict, a conflict this rank finds, or a dead missing member."""
        now = time.monotonic()
        for t, t0 in list(self.open.items()):
            if now - t0 >= _SLOW_SEC:
                self._post_record(t, store)
        for t, entry in list(self.waiting.items()):
            waited = now - entry[0]
            if waited < _SLOW_SEC:
                continue
            if t.req is not None and not entry[1]:
                store.set(f"c/{self.rank}", json.dumps(
                    [t.st.key, t.k, t.name, list(t.st.members)]))
                entry[1] = True
            reason = basics.aborted()
            if reason is not None:
                self._end(store, t, "abort", f"negotiation of '{t.name}': "
                          f"the process group was aborted: {reason}")
            elif store.check([f"v/{t.st.key}/{t.k}"]) or (
                    t.req is not None and self._conflict(store, t)):
                self._end(store, t, "verdict")
            elif waited > _DEAD_SEC:
                dead = self._dead(store, self._missing(store, t))
                if dead:
                    self._end(store, t, "dead", f"negotiation of "
                              f"'{t.name}': ranks {dead} stopped (a peer "
                              "was lost)")

    def _end(self, store, t, kind, text=""):
        """End the ticket's wait: a poll of the board on this rank, or the
        store's reads of its position on every member that waits there (a
        stand-in record for each member that has none)."""
        if t.on_board:
            t.ended = (kind, text)
            return
        record = "X " + json.dumps({"kind": kind, "text": text})
        for key in t.keys:
            store.compare_set(key, "", record)

    def release(self, reason):
        """End every wait of this process (``basics.abort``)."""
        store = self.store()
        for t in list(self.waiting):
            self._end(store, t, "abort", f"negotiation of '{t.name}': the "
                      f"process group was aborted: {reason}")

    def _dead(self, store, ranks):
        now, dead = time.time(), []
        for m in ranks:
            key = f"h/{m}"
            if store.check([key]) and \
                    now - float(store.get(key)) > _DEAD_SEC:
                dead.append(m)
        return dead

    # -------------------------------------------------------- conflicts
    def _status(self, store, rank, cache):
        """(set, position, tensor, members) of what ``rank`` waits on, or
        None when it has not said."""
        if rank not in cache:
            key, cache[rank] = f"c/{rank}", None
            if store.check([key]):
                try:    # the rank may end its read and delete it meanwhile
                    cache[rank] = json.loads(store.get(key))
                except (RuntimeError, ValueError):
                    pass
        return cache[rank]

    def _posted(self, store, key, pos, members) -> bool:
        """Whether every one of ``members`` posted at the set's position."""
        if self._board_index(key) is not None:
            return all(self.board.read(int(key), list(members), pos)[1])
        return store.check([f"r/{key}/{pos}/{m}" for m in members])

    def _conflict(self, store, t):
        """Whether the ticket's tensor waits on overlapping sets that can
        never complete (the engine's cross-set check): every member of
        every such set posted the name, and no set has all its members. If
        so the verdict is posted for every such set's position."""
        st, k, name = t.st, t.k, t.name
        cache = {}
        entries = {(st.key, k): list(st.members)}
        todo = list(st.members)
        seen = set()
        while todo:
            r = todo.pop()
            if r in seen:
                continue
            seen.add(r)
            if self._joined(store, r):
                continue
            s = self._status(store, r, cache)
            if s is None:
                if self._posted(store, st.key, k, [r]):
                    continue    # posted here without waiting long yet
                return False
            if s[2] != name:
                return False    # busy with another tensor: a stall
            entries[(s[0], s[1])] = s[3]
            todo.extend(s[3])
        if len(entries) < 2:
            return False
        for (key, pos), members in entries.items():
            if self._posted(store, key, pos, members):
                return False    # that set completes
        text = json.dumps({
            "error": f"tensor '{name}' was submitted with conflicting "
                     "process sets across ranks",
            "entries": [[key, pos, members]
                        for (key, pos), members in sorted(entries.items())]})
        for key, pos in entries:
            store.compare_set(f"v/{key}/{pos}", "", text)
        return True

    def _adopt(self, verdict):
        """Take a conflict's verdict: every set in it moves on past its
        position on this rank, as on every other member, and its keys
        there are deleted once every member has read them."""
        v = json.loads(verdict)
        for key, pos, members in v["entries"]:
            if self.rank in members:
                other = self.set_for(key, members)
                other.pos = max(other.pos, pos + 1)
                self._read(other, pos)
                if other.board is None:
                    with self.lock:
                        other.verdicts.append(pos)
                else:
                    with self.lock:
                        self.posted.append((
                            other.board, pos, other.members,
                            [f"r/{key}/{pos}/{m}" for m in members] +
                            [f"v/{key}/{pos}"]))
        return v["error"]

    def _joined(self, store, rank):
        key = f"j/{rank}"
        return store.check([key]) and store.get(key) == b"1"

    def mark_joined(self, on: bool):
        self.store().set(f"j/{self.rank}", "1" if on else "0")

    # ---------------------------------------------------- the inspector
    def _inspect(self):
        """Heartbeats, the watch over this rank's waits, the deletion of
        the store keys every member has read, and the stall inspector over
        the sets this rank is the lowest member of."""
        scan_every = max(_WATCH_SEC, min(1.0, self.warn_sec / 4))
        beat = scanned = 0.0
        reported = False
        store = self._client(_INSPECT_TIMEOUT)
        while not self.stop.wait(_WATCH_SEC):
            try:
                now = time.time()
                if now - beat >= _HEARTBEAT_SEC:
                    store.set(f"h/{self.rank}", f"{now:.3f}")
                    beat = now
                self._watch(store)
                self._reap(store)
                if now - scanned >= scan_every:
                    self._scan(store)
                    scanned = now
            except RuntimeError:
                pass    # the store is gone: the reads raise for it
            except Exception:   # the watch must go on: report it once
                if not reported:
                    reported = True
                    traceback.print_exc()

    def _reap(self, store):
        """Delete what every member has read. A store set's positions go
        ``_SWEEP`` at a time: each member adds one to their counter once it
        has read them all; once the counter holds every member, each member
        deletes its own records there (the lowest also the verdicts) and
        adds one again, and the member that brings it to twice the set's
        size deletes the counter. A board position's keys, which only this
        rank posted, go once every member's next read is past it."""
        for st in list(self.sets.values()):
            if st.board is not None:
                continue
            n = len(st.members)
            while st.done_pos >= st.said + _SWEEP:
                store.add(f"n/{st.key}/{st.said}", 1)
                st.said += _SWEEP
            while st.swept < st.said:
                lo, counter = st.swept, f"n/{st.key}/{st.swept}"
                if store.add(counter, 0) < n:
                    break
                for k in range(lo, lo + _SWEEP):
                    store.delete_key(f"r/{st.key}/{k}/{self.rank}")
                with self.lock:
                    done = [k for k in st.verdicts if k < lo + _SWEEP]
                    st.verdicts = [k for k in st.verdicts
                                   if k >= lo + _SWEEP]
                if self.rank == st.members[0]:
                    for k in done:
                        store.delete_key(f"v/{st.key}/{k}")
                if store.add(counter, 1) >= 2 * n:
                    store.delete_key(counter)
                st.swept = lo + _SWEEP
        with self.lock:
            posted, self.posted = self.posted, []
        keep = []
        for item in posted:
            s, k, members, keys = item
            if self.board.done[s, list(members)].min() > k:
                for key in keys:
                    store.delete_key(key)
            else:
                keep.append(item)
        with self.lock:
            self.posted[:0] = keep

    def _lowest_sets(self):
        """The sets whose lowest member this rank is: the global set on
        rank 0, and every registered set of two or more."""
        out = [self.set_for("0", range(self.size))] if self.rank == 0 \
            else []
        world = basics._state
        for ps in list(world.process_sets.values()) if world else ():
            ranks = ps.ranks
            if ranks and ranks[0] == self.rank and \
                    1 < len(ranks) < self.size:
                out.append(self.set_state(ps))
        return out

    def _scan(self, store):
        now = time.time()
        table = {}
        for st in self._lowest_sets():
            k = st.done_pos
            keys = [f"r/{st.key}/{k}/{m}" for m in st.members]
            there = [(m, key) for m, key in zip(st.members, keys)
                     if store.check([key])]
            if not there or len(there) == len(keys):
                continue
            recs = store.multi_get([key for _, key in there])
            by_name = {}
            for (m, _), raw in zip(there, recs):
                t, payload = raw.decode().split(" ", 1)
                if t == "X" or payload[0] == "J":
                    continue    # a stand-in record, or a joined rank
                q = _from_json(json.loads(payload))
                e = by_name.setdefault(q[NAMES][0], [q[OP], float(t), []])
                e[1] = min(e[1], float(t))
                e[2].append(m)
            for tensor, (op, first, arrived) in by_name.items():
                missing = [m for m in st.members if m not in arrived
                           and not self._joined(store, m)]
                if not missing:
                    continue
                table[(st.key, k, tensor)] = {
                    "tensor": tensor, "op": op.upper(), "first": first,
                    "arrived_ranks": sorted(arrived),
                    "missing_ranks": missing}
                waiting = now - first
                if waiting > self.warn_sec and \
                        (st.key, k, tensor) not in self.warned:
                    self.warned.add((st.key, k, tensor))
                    _stall_counter().inc()
                    print(f"[hvt:{self.rank}] WARNING: tensor '{tensor}' "
                          "was submitted by some ranks but not by ranks "
                          f"[ {''.join(f'{m} ' for m in missing)}] for "
                          f"{int(waiting)} s — possible stall (reference "
                          "stall_inspector semantics)", file=sys.stderr,
                          flush=True)
        self.table = table
        gauge = _missing_gauge()
        stalled = {row["tensor"]: len(row["missing_ranks"])
                   for row in self.stalls(now)}
        for labels, child in gauge.samples():
            if labels.get("tensor") not in stalled:
                child.set(0)
        for tensor, n in stalled.items():
            gauge.labels(tensor=tensor).set(n)

    def rows(self, now=None):
        now = time.time() if now is None else now
        out = []
        for row in list(self.table.values()):
            out.append({"tensor": row["tensor"], "op": row["op"],
                        "waiting_sec": round(now - row["first"], 3),
                        "arrived_ranks": row["arrived_ranks"],
                        "missing_ranks": row["missing_ranks"]})
        return out

    def stalls(self, now=None):
        return [row for row in self.rows(now)
                if row["missing_ranks"] and
                row["waiting_sec"] > self.warn_sec]


class _NamesDiffer(Exception):
    """Members posted different tensors at one position."""


def _stall_counter():
    from horovod_tpu_torch import metrics

    return metrics.registry().counter(
        "hvt_engine_stalls_total",
        "stall-inspector warnings (some ranks missing a tensor)")


def _missing_gauge():
    from horovod_tpu_torch import metrics

    return metrics.registry().gauge(
        "hvt_stall_missing_ranks",
        "ranks that have not submitted a stalled tensor, by tensor",
        ("tensor",))


_coord = None
_local_names = [0]      # unnamed collectives over sets of one process


def start(rank, size, timeout_s):
    """A new world's coordinator (``basics.init``): nothing of the last
    world's survives."""
    global _coord
    stop()
    _coord, _local_names[0] = None, 0
    if size > 1:
        _coord = _Coordinator(dist.distributed_c10d._get_default_store(),
                              rank, size, timeout_s)


def stop():
    """Stop the inspector (``basics.shutdown``). Rank 0 keeps the store
    server up until the next world, so that a peer still reading the last
    requests is not cut off."""
    c = _coord
    if c is not None:
        c.stop.set()
        c.thread.join(timeout=5)


atexit.register(stop)   # the inspector stops before the interpreter does


def post(op, process_set, tensors, name=None, reduce="", root=-1,
         prescale=1.0, postscale=1.0, splits=None, grouped=False,
         label=None) -> Ticket:
    """Post one eager collective's request (see the module docstring);
    returns its :class:`Ticket` for :func:`ready` and :func:`finish`.
    ``tensors`` is the tensor (a list for a grouped call) whose dtype and
    shape go in the request; ``label`` names unnamed tensors (default
    ``op``)."""
    c = _coord
    if c is None:
        raise HorovodInternalError(f"{op}: no world is running")
    st = c.set_state(process_set)
    ts = list(tensors) if grouped else [tensors]
    if grouped:
        st.groups += 1
        gid, gsize = st.groups, len(ts)
        names = [f"{name}.{i}" if name else _auto(st, label or op)
                 for i in range(len(ts))]
    else:
        gid, gsize = -1, 0
        names = [name or _auto(st, label or op)]
    req = (tuple(names), op,
           tuple(str(t.dtype) if t is not None else "" for t in ts),
           tuple(tuple(t.shape) if t is not None else () for t in ts),
           reduce, root, float(prescale), float(postscale), gid, gsize,
           None if splits is None else tuple(splits))
    return c.post(st, req)


def local(op, process_set, name=None):
    """The outcome of a collective over a set of one process, which is not
    negotiated: with a timeline recording, its lifecycle lane (``ENQUEUED``
    and ``DONE`` around the exec span; an unnamed call gets the engine's
    default name, so that async calls in flight keep lanes apart), else
    None."""
    if not timeline.active():
        return None
    if name is None:
        _local_names[0] += 1
        name = f"hvt.{op}.{_local_names[0]}"
    return Outcome(None, None, 0, name + _LANE,
                   process_set.process_set_id or 0)


def ready(ticket, verdicts=False) -> bool:
    """Whether every member's record at the ticket's position is there,
    or with ``verdicts`` a conflict's verdict (a look at the board or the
    store; never blocks)."""
    return _coord.ready(ticket, verdicts)


def window_full(process_set) -> bool:
    """Whether this rank has posted ``WINDOW`` positions of the set that it
    has not read (a set on the board, where a ring's record must be read
    by every member before it is written again)."""
    st = _coord.set_state(process_set)
    return st.board is not None and st.pos - st.done_pos >= WINDOW


def finish(ticket) -> Outcome:
    """The ticket's :class:`Outcome`, once every member has posted."""
    c = _coord
    try:
        return c.finish(ticket)
    except _NamesDiffer as e:
        _wait_forever(c, e)


def negotiate(op, process_set, tensors, **request) -> Outcome:
    """:func:`post` and :func:`finish` of one collective."""
    return finish(post(op, process_set, tensors, **request))


def _auto(st, op):
    st.names += 1
    return f"hvt.{op}.{st.names}"


def _wait_forever(c, e):
    """Members posted different tensors at one position: as two blocking
    calls of different names in the engine, nothing can complete. Wait
    (the inspector names the ranks) until the world is aborted or the
    process group's timeout passes."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < c.timeout_s:
        if basics.aborted() is not None:
            raise HorovodInternalError(
                f"the process group was aborted: {basics.aborted()}")
        time.sleep(_POLL_SEC)
    names = sorted(n[0] for n in e.args[0])
    raise HorovodInternalError(
        f"ranks submitted different tensors {names} at one position and "
        f"waited {c.timeout_s} s")


def join_round(process_set, joined_at, called_us):
    """One position of the global set as a rank inside ``join()``: post
    the join record and return the :class:`Outcome` (the active ranks'
    requests, None for each joined rank)."""
    c = _coord
    return finish(c.post(c.set_state(process_set), None,
                         joined=[joined_at, called_us]))


def follow(process_set, req):
    """As a joined rank standing in for the active ranks' request ``req``,
    take their count of grouped calls and unnamed tensors, which only the
    ranks that called advanced, so that the calls after the join pair."""
    st = _coord.set_state(process_set)
    st.groups = max(st.groups, req[GID])
    for name in req[NAMES]:
        parts = name.split(".")
        if len(parts) == 3 and parts[0] == "hvt" and parts[2].isdigit():
            st.names = max(st.names, int(parts[2]))


def release(reason):
    """End this process's waits: the world was aborted (``basics.abort``,
    from any thread)."""
    c = _coord
    if c is not None:
        try:
            c.release(reason)
        except RuntimeError:
            pass    # the store is gone: the reads raise for it


def position(process_set) -> int:
    """The next position this rank negotiates on the set."""
    return _coord.set_state(process_set).pos


def mark_joined(on: bool):
    if _coord is not None:
        _coord.mark_joined(on)


def diagnostics() -> dict:
    """``negotiations`` (each with tensor, op, ``waiting_sec``,
    ``arrived_ranks`` and ``missing_ranks``) and ``stalls`` (those past
    ``HVT_STALL_WARN_SEC``), as the engine lays them out
    (``engine.cc:2652-2675``), from this rank's inspector: the sets it is
    the lowest member of."""
    c = _coord
    if c is None:
        return {"negotiations": [], "stalls": [], "stall_warn_sec": None}
    now = time.time()
    return {"negotiations": c.rows(now), "stalls": c.stalls(now),
            "stall_warn_sec": c.warn_sec}
