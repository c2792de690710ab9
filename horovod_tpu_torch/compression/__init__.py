"""``horovod_tpu_torch.compression``: the wire codecs of the compressed
allreduce (the JAX package's ``horovod_tpu/compression`` and the engine's
codec plumbing, ``csrc/engine.cc``), on ``torch.distributed``.

``HVT_WIRE_COMPRESSION`` picks a codec per link class: a name (``bf16``,
``int8``, ``fp8``; ``none``/``raw``/empty move raw bytes) for both, an
``<intra>,<inter>`` pair, ``auto`` (intra raw, inter picked by the tuner) or
``<intra>,auto``. An unknown name moves raw bytes with a warning. The spec
is read at ``hvt.init``. An fp32 Sum or Average allreduce (not Adasum) over
more than one process whose codec is lossy takes the compressed route of
``ops/hierarchical.py``: encoded chunks exchanged by ``all_to_all``, summed
in rank order, each owner's sum encoded and gathered, so every rank decodes
the same bits. The codec kernels are ``csrc/wire_codec.cu``
(``compression/codecs.py``).

Error feedback (``HVT_ERROR_FEEDBACK``, default 1) adds each tensor's
stored quantization error to its next submission and quantizes the sum on
the first lossy hop's codec, keeping the new error; residuals live on the
device, keyed by (tensor name, process set), within ``HVT_EF_MAX_BYTES``
(default 64 MiB) with LRU eviction.

Under ``auto`` a :class:`CodecTuner` (the engine's ``csrc/autotune.h``)
tries none, bf16 and int8 five times each per (link class, log2 size
bucket) and locks the best bytes per ns. The JAX engine's rank 0 decides
alone and stamps its pick into every response; the port has no
coordinator, so each process set has a tuner of its own, which only the
set's calls observe; while a cell explores, the members of the call agree
on the observed time by one 8-byte Max allreduce, and every member's tuner
then holds the same cells and locks the same winner. A locked cell costs
no collective.

Distinct from ``hvt.Compression`` (a cast before the collective): the wire
codecs are transparent to callers and exist only between processes.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import OrderedDict

# codec name -> wire id (horovod_tpu/csrc/codecs.h registry order)
CODEC_IDS = {"none": 0, "bf16": 1, "int8": 2, "fp8": 3}

# wire id -> name (index == id)
CODEC_NAMES = tuple(sorted(CODEC_IDS, key=CODEC_IDS.get))

# the op label the wire counters carry (the engine's op of a grouped
# allreduce's fused buffer is an allreduce too)
WIRE_OP = "allreduce"


def codec_id(name: str) -> int:
    """Wire id for a codec name (``"raw"``/``""`` alias ``"none"``).
    Raises ``ValueError`` for unknown names."""
    if name in ("", "raw"):
        return 0
    if name not in CODEC_IDS:
        raise ValueError(
            f"unknown wire codec {name!r} (known: {CODEC_NAMES})")
    return CODEC_IDS[name]


def codec_name(wire_id: int) -> str:
    """Codec name for a wire id; an unknown id renders as ``"codec<id>"``
    rather than raising."""
    if 0 <= wire_id < len(CODEC_NAMES):
        return CODEC_NAMES[wire_id]
    return f"codec{wire_id}"


def parse_wire_spec(spec, warn=None) -> tuple:
    """``(intra_id, inter_id, auto)`` of an ``HVT_WIRE_COMPRESSION`` value,
    by the engine's rules (``csrc/engine.cc:180-222``): one token names both
    link classes (``auto`` alone: intra raw, inter tuned); a pair splits
    them, and only the inter token may be ``auto``; an unknown token moves
    raw bytes (``warn(message)`` is called with the engine's warning)."""
    spec = spec or ""
    auto = False

    def tok(t, allow_auto):
        nonlocal auto
        if allow_auto and t == "auto":
            auto = True
            return 0
        if t in ("", "raw"):
            return 0
        if t not in CODEC_IDS:
            if warn is not None:
                warn(f"HVT_WIRE_COMPRESSION: unknown codec '{t}' — moving "
                     f"raw bytes")
            return 0
        return CODEC_IDS[t]

    if "," not in spec:
        wid = tok(spec, True)
        return (0 if auto else wid), wid, auto
    intra, inter = spec.split(",", 1)
    intra_id = tok(intra, False)
    return intra_id, tok(inter, True), auto


class CodecTuner:
    """Wire-codec auto-selection (the engine's ``CodecTuner``,
    ``csrc/autotune.{h,cc}``): per (link class, log2-size bucket), try each
    candidate ``TRIALS`` times in a fixed rotation, then lock the argmax of
    bytes per ns. Deterministic: ranks fed the same observations pick the
    same codecs. fp8 is never picked: it moves int8's bytes with looser
    error bounds, so it can only tie."""

    CANDIDATES = (0, 1, 2)      # none, bf16, int8
    TRIALS = 5                  # samples per candidate per cell
    BUCKETS = 18                # log2 bytes, <= 2 KB .. 128 MB+

    def __init__(self):
        self.reset()

    def reset(self):
        self._cells = [[self._cell() for _ in range(self.BUCKETS)]
                       for _ in range(2)]

    def _cell(self):
        k = len(self.CANDIDATES)
        return {"ns": [0] * k, "bytes": [0] * k, "n": [0] * k,
                "locked": -1}

    @classmethod
    def bucket(cls, nbytes: int) -> int:
        b = 0
        while (1 << (b + 11)) < nbytes and b < cls.BUCKETS - 1:
            b += 1
        return b    # bucket 0 <= 2 KB, each next doubles

    def _at(self, nbytes, link):
        return self._cells[link & 1][self.bucket(nbytes)]

    def pick(self, nbytes: int, link: int) -> int:
        """Codec id to use for ``nbytes`` of payload on link class ``link``
        (0 intra, 1 inter): the candidate still short of its trials, or
        the locked winner (locked by this call once all are sampled)."""
        cell = self._at(nbytes, link)
        if cell["locked"] >= 0:
            return self.CANDIDATES[cell["locked"]]
        for i, c in enumerate(self.CANDIDATES):
            if cell["n"][i] < self.TRIALS:
                return c
        best, best_tp = 0, -1.0
        for i in range(len(self.CANDIDATES)):
            tp = (cell["bytes"][i] / cell["ns"][i]) if cell["ns"][i] > 0 \
                else 0.0
            if tp > best_tp:
                best, best_tp = i, tp
        cell["locked"] = best
        return self.CANDIDATES[best]

    def observe(self, nbytes: int, link: int, codec: int, ns: int):
        """A measured run of a payload that ``pick`` chose ``codec`` for."""
        if codec not in self.CANDIDATES or ns <= 0:
            return
        i = self.CANDIDATES.index(codec)
        cell = self._at(nbytes, link)
        cell["ns"][i] += int(ns)
        cell["bytes"][i] += int(nbytes)
        cell["n"][i] += 1

    def locked(self, nbytes: int, link: int) -> bool:
        return self._at(nbytes, link)["locked"] >= 0


class EfStore:
    """Error-feedback residuals keyed by (tensor name, lane), the engine's
    ``EfResidual`` (``csrc/engine.cc:2709-2751``): at most ``max_bytes`` of
    fp32 residuals, least recently used evicted first; a tensor larger than
    the whole budget gets none. ``dropped`` counts evictions and refusals."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self.bytes = 0
        self.dropped = 0
        self._bufs = OrderedDict()      # key -> tensor, least recent first

    def residual(self, name: str, lane: str, like):
        """The residual (zeros at first) of ``name`` on ``lane``, shaped and
        placed like the flat tensor ``like``; None over budget."""
        need = like.numel() * 4
        if need > self.max_bytes:
            self.dropped += 1
            return None
        key = f"{name}\x1f{lane}"
        buf = self._bufs.get(key)
        if buf is not None and (buf.numel() != like.numel()
                                or buf.device != like.device):
            # another tensor under the same name: start clean
            self.bytes -= buf.numel() * 4
            del self._bufs[key]
            buf = None
        if buf is None:
            while self.bytes + need > self.max_bytes and self._bufs:
                _, old = self._bufs.popitem(last=False)
                self.bytes -= old.numel() * 4
                self.dropped += 1
            buf = like.new_zeros(like.numel())
            self._bufs[key] = buf
            self.bytes += need
        else:
            self._bufs.move_to_end(key)
        return buf


class _WireState:
    """The spec this world was started with, the tuners, the residuals and
    the current pair (what :func:`wire_pair` reports). Each process set
    has its own tuner, so that only a call's members observe its cells."""

    def __init__(self, environ=os.environ):
        self.intra, self.inter, self.auto = parse_wire_spec(
            environ.get("HVT_WIRE_COMPRESSION"), warn=_warn)
        self.cur_intra, self.cur_inter = self.intra, self.inter
        self.ef_enabled = environ.get("HVT_ERROR_FEEDBACK", "1") not in (
            "", "0")
        self.ef = EfStore(int(environ.get("HVT_EF_MAX_BYTES") or 64 << 20))
        self.tuners = {}        # process-set label -> CodecTuner
        self.lock = threading.Lock()

    def lossy(self) -> bool:
        return bool(self.intra or self.inter or self.auto)

    def tuner(self, label: str) -> CodecTuner:
        """The tuner of the process set labelled ``label`` (``"global"``
        or its sorted ranks), made on its first call."""
        with self.lock:
            return self.tuners.setdefault(label, CodecTuner())


_state = None


def _warn(msg):
    print(f"[hvt] WARNING: {msg}", file=sys.stderr)


def configure(environ=os.environ):
    """Read the wire spec and start with no residuals and fresh tuners
    (``hvt.init``; the engine's re-init does the same)."""
    global _state
    _state = _WireState(environ)
    _metric_handles()[2].set(0)
    return _state


def state():
    """The running spec, or None before ``hvt.init``."""
    return _state


def wire_pair() -> tuple:
    """The current ``(intra, inter)`` codec-name pair, e.g. ``("none",
    "int8")`` under ``HVT_WIRE_COMPRESSION=none,int8``. Under ``auto`` the
    inter codec is the tuner's latest pick. ``("none", "none")`` before
    ``hvt.init``."""
    st = _state
    if st is None:
        return ("none", "none")
    return (codec_name(st.cur_intra), codec_name(st.cur_inter))


def auto_active() -> bool:
    """True while ``HVT_WIRE_COMPRESSION=auto`` (or ``<intra>,auto``)
    drives the inter codec."""
    return bool(_state is not None and _state.auto)


def tx_bytes(op: str = None) -> dict:
    """Compressed bytes sent, from ``hvt_wire_tx_bytes_total{op,codec}``:
    with ``op`` ``{codec: bytes}``, without ``{codec: {op: bytes}}``."""
    tx = _metric_handles()[0]
    by_codec = {}
    for labels, child in tx.samples():
        by_codec.setdefault(labels["codec"], {})[labels["op"]] = int(
            child.value)
    if op is None:
        return by_codec
    return {codec: ops.get(op, 0) for codec, ops in by_codec.items()}


_handles = None     # (registry, (tx, tx_compressed, ef_bytes, ef_dropped))


def _metric_handles():
    global _handles
    from horovod_tpu_torch import metrics

    reg = metrics.registry()
    if _handles is None or _handles[0] is not reg:
        _handles = (reg, (
            reg.counter("hvt_wire_tx_bytes_total",
                        "bytes of encoded wire streams sent to other "
                        "processes by the compressed allreduce, by "
                        "collective op and wire codec", ("op", "codec")),
            reg.counter("hvt_wire_tx_compressed_bytes_total",
                        "bytes sent in compressed form "
                        "(HVT_WIRE_COMPRESSION), by collective op",
                        ("op",)),
            reg.gauge("hvt_ef_residual_bytes",
                      "resident error-feedback residual bytes (per-tensor "
                      "fp32 quantization-error memory on the device, "
                      "bounded by HVT_EF_MAX_BYTES)"),
            reg.counter("hvt_ef_residuals_dropped_total",
                        "error-feedback residual buffers evicted or "
                        "refused by the HVT_EF_MAX_BYTES budget")))
    return _handles[1]


def count_tx(codec: str, nbytes: int):
    """Count ``nbytes`` of ``codec`` streams sent to other processes."""
    if nbytes <= 0:
        return
    tx, txc, _, _ = _metric_handles()
    tx.labels(op=WIRE_OP, codec=codec).inc(nbytes)
    txc.labels(op=WIRE_OP).inc(nbytes)


def note_ef():
    """Publish the residual store's size and drops."""
    st = _state
    if st is None:
        return
    _, _, ef_bytes, ef_dropped = _metric_handles()
    ef_bytes.set(st.ef.bytes)
    ef_dropped.labels().set_total(st.ef.dropped)
