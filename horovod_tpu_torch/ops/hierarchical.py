"""Hierarchical allreduce and allgather (the JAX package's
``ops/hierarchical.py``; Horovod's NCCLHierarchicalAllreduce,
``ops/nccl_operations.cc:188-350``).

The JAX package's two mesh axes become two families of process groups,
built from each rank's ``local_rank`` and ``cross_rank``: a "local" group
per host (the ranks with one ``cross_rank``) and a "cross" group per local
slot (the ranks with one ``local_rank``). Allreduce is a reduce-scatter
over local, an allreduce of one 1/local_size slice over cross, and an
allgather over local, so each host sends 1/local_size of the bytes across
hosts. Ranks must be host-major (rank = cross_rank · local_size +
local_rank), as the ``hvtrun`` launcher assigns them. The groups are made
on first use, collectively, so every process makes its first hierarchical
call together.

:func:`compressed_allreduce` is the route of an allreduce whose wire codec
is lossy (``horovod_tpu_torch.compression``; the JAX engine's hierarchical
backend with its codec pair, ``csrc/engine.cc``). On the global set of a job
on several hosts with several processes a host, the local stages stay
reduce-scatter and allgather (compressed when the intra codec is lossy) and
the cross stage becomes a compressed reduce-scatter and allgather under the
inter codec. A process set, or a job with one process a host, takes one
compressed reduce-scatter and allgather over its group, under the intra
codec when its members share a host and the inter codec otherwise. A
compressed reduce-scatter and allgather over a group of g:

1. cuts the buffer into g chunks whose bounds are whole blocks of 256
   elements (the last chunk may be short or empty), encodes the buffer
   once (a chunk's stream is a slice of it) and sends chunk j to member j
   with ``all_to_all``;
2. each member sums its chunk in member order, its own contribution raw,
   the others' decoded;
3. each member encodes its sum, the streams are gathered, and every member
   decodes every chunk, its own too, so all hold the same bits.

Before any of it, error feedback quantizes each tensor of the buffer on the
first lossy hop's codec with its stored residual
(``compression.EfStore``), as the engine does (``csrc/engine.cc:3250-3284``).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from horovod_tpu_torch import compression
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.compression import codecs as W
from horovod_tpu_torch.ops import collective_ops as C


def _new_group(ranks):
    return dist.group.WORLD if ranks == list(range(basics.size())) \
        else dist.new_group(ranks)


def _groups():
    """(local group, cross group, local size, cross size) of this rank."""
    world = basics._world()
    if "hierarchical" not in world.groups:
        n, L, Cs = basics.size(), basics.local_size(), basics.cross_size()
        me = torch.tensor([[basics.cross_rank(), basics.local_rank()]],
                          device=basics.device())
        coords = [tuple(c) for c in C.allgather(me).tolist()]
        if L * Cs != n or coords != [divmod(r, L) for r in range(n)]:
            raise ValueError(
                f"hierarchical collectives need a homogeneous, host-major "
                f"job (rank = cross_rank * local_size + local_rank); got "
                f"(cross_rank, local_rank) {coords} with local_size {L}, "
                f"cross_size {Cs}")
        # new_group is collective: every process makes every group
        local = [_new_group(list(range(c * L, (c + 1) * L)))
                 for c in range(Cs)]
        cross = [_new_group(list(range(l, n, L))) for l in range(L)]
        world.groups["hierarchical"] = (local[basics.cross_rank()],
                                        cross[basics.local_rank()], L, Cs)
    return world.groups["hierarchical"]


def hierarchical_allreduce(tensor, average=False):
    """Allreduce ``tensor`` over every process by reduce-scatter over
    local, allreduce over cross and allgather over local. The same sum as
    ``allreduce(op=Sum)`` (divided by the world size when ``average``; an
    integer tensor then gives the float mean); the flat tensor is
    zero-padded to a multiple of the local size and unpadded after."""
    local, cross, L, Cs = _groups()
    flat = tensor.detach().reshape(-1)
    n = flat.numel()
    pad = (-n) % L
    flat = torch.cat([flat, flat.new_zeros(pad)]) if pad \
        else flat.contiguous()
    piece = flat.new_empty(flat.numel() // L)
    C._collective(dist.reduce_scatter_tensor, piece, flat, group=local)
    C._collective(dist.all_reduce, piece, group=cross)
    full = flat.new_empty(flat.numel())
    C._collective(dist.all_gather_into_tensor, full, piece, group=local)
    full = full[:n].view(tensor.shape)
    return full / (L * Cs) if average else full


def hierarchical_allgather(tensor):
    """Gather ``tensor`` (the same shape on every rank) across hosts, then
    within the host; concatenated along dim 0 in global rank order."""
    local, cross, L, Cs = _groups()
    t = tensor.detach()
    flat = t.reshape(-1).contiguous()
    over_cross = flat.new_empty(Cs * flat.numel())
    C._collective(dist.all_gather_into_tensor, over_cross, flat, group=cross)
    over_both = flat.new_empty(L * over_cross.numel())
    C._collective(dist.all_gather_into_tensor, over_both, over_cross,
                  group=local)
    # [local, cross, ...] -> global rank order, rank = cross * L + local
    return over_both.view((L, Cs) + t.shape).transpose(0, 1).reshape(
        (-1,) + t.shape[1:])


# --------------------------------------------------------------------------
# the compressed allreduce
# --------------------------------------------------------------------------

INTRA, INTER = 0, 1     # link classes (the tuner's cells)


def wire_plan(process_set):
    """How an eligible allreduce over ``process_set`` crosses the wire:
    ``("hier", INTER)`` (local stages under the intra codec, the cross
    stage under the inter codec), ``("flat", link)`` (one compressed
    reduce-scatter and allgather under that link class's codec), or None
    when no codec on its path is lossy: raw bytes, as without the spec."""
    st = compression.state()
    if st is None or not st.lossy() or process_set.size() < 2:
        return None
    L = basics.local_size()
    if process_set.ranks is None:
        one_host, many_local = basics.cross_size() == 1, L > 1
    else:
        one_host = len({r // L for r in process_set.ranks}) == 1
        many_local = False
    if one_host:
        return ("flat", INTRA) if st.intra else None
    if many_local:
        return ("hier", INTER)
    return ("flat", INTER) if st.inter or st.auto else None


def _pick(st, tuner, link, nbytes):
    """The codec id of this call's ``link`` hop and whether ``tuner`` (the
    call's process set's) is still exploring its cell (then the hop is
    timed and agreed)."""
    if link == INTRA:
        return st.intra, False
    if not st.auto:
        return st.inter, False
    with st.lock:
        exploring = not tuner.locked(nbytes, INTER)
        codec = tuner.pick(nbytes, INTER)
        st.cur_inter = codec
    return codec, exploring


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stage(st, tuner, fn, exploring, device, agree_group, nbytes, codec):
    """Run the stage ``fn()`` that moves ``nbytes`` under ``codec``. While
    ``tuner`` explores, time it and give it the Max over ``agree_group``
    (the call's members) of every member's time (8 bytes, one allreduce),
    so every member's tuner records the same observation."""
    if not exploring:
        fn()
        return
    _sync(device)
    t0 = time.perf_counter_ns()
    fn()
    _sync(device)
    ns = torch.tensor([float(time.perf_counter_ns() - t0)],
                      dtype=torch.float64, device=device)
    C._collective(dist.all_reduce, ns, op=dist.ReduceOp.MAX,
                  group=agree_group)
    with st.lock:
        tuner.observe(nbytes, INTER, codec, int(ns.item()))


def _chunks(m, g):
    """(chunk elements c, each member's chunk length): bounds on whole
    blocks, the last chunks short or empty."""
    c = -(-m // (W.BLOCK * g)) * W.BLOCK
    return c, [max(0, min(c, m - j * c)) for j in range(g)]


def _reduce_scatter(x, group, g, me, codec):
    """Compressed reduce-scatter of flat fp32 ``x``: (this member's chunk
    sum, c, lens)."""
    name = compression.codec_name(codec)
    m = x.numel()
    c, lens = _chunks(m, g)
    stream = W.encode(x, name)
    sizes = [W.wire_bytes(name, k) for k in lens]
    recv = torch.empty(g * sizes[me], dtype=torch.uint8, device=x.device)
    C._collective(dist.all_to_all_single, recv, stream,
                  output_split_sizes=[sizes[me]] * g,
                  input_split_sizes=sizes, group=group)
    compression.count_tx(name, sum(sizes) - sizes[me])
    mine = x[me * c:me * c + lens[me]]
    acc = torch.empty_like(mine)
    for r in range(g):
        if r == me:
            if r == 0:
                acc.copy_(mine)
            else:
                acc.add_(mine)
        elif lens[me]:
            W.decode_accumulate(recv[r * sizes[me]:(r + 1) * sizes[me]],
                                name, lens[me], out=acc, accumulate=r > 0)
    return acc, c, lens


def _allgather(acc, c, lens, group, g, me, codec, out):
    """Compressed allgather of each member's chunk sum into ``out`` (flat
    fp32, ``sum(lens)`` elements): every chunk decoded from its stream."""
    name = compression.codec_name(codec)
    slot = W.wire_bytes(name, c)
    stream = W.encode(acc, name)
    if stream.numel() < slot:
        stream = torch.cat([stream, stream.new_zeros(slot - stream.numel())])
    gathered = torch.empty(g * slot, dtype=torch.uint8, device=acc.device)
    C._collective(dist.all_gather_into_tensor, gathered, stream, group=group)
    compression.count_tx(name, (g - 1) * W.wire_bytes(name, lens[me]))
    for j, k in enumerate(lens):
        if k:
            W.decode_accumulate(
                gathered[j * slot:j * slot + W.wire_bytes(name, k)], name,
                k, out=out[j * c:j * c + k])
    return out


def _group_allreduce(x, group, g, me, codec):
    """Sum flat fp32 ``x`` over ``group`` in place: compressed under a
    lossy ``codec``, a raw allreduce under none."""
    if not codec:
        C._collective(dist.all_reduce, x, group=group)
        return x
    acc, c, lens = _reduce_scatter(x, group, g, me, codec)
    return _allgather(acc, c, lens, group, g, me, codec, x)


def _error_feedback(flat, codec, names, segments, lane):
    """Each tensor's segment quantized on ``codec`` with its residual (a
    plain roundtrip when the budget refuses one)."""
    st = compression.state()
    name = compression.codec_name(codec)
    off = 0
    for tensor_name, k in zip(names, segments):
        seg = flat[off:off + k]
        if k:
            W.ef_roundtrip(seg, name, st.ef.residual(tensor_name, lane, seg))
        off += k
    compression.note_ef()


def compressed_allreduce(buf, process_set, plan, names=None, segments=None):
    """Sum the fp32 ``buf`` over ``process_set`` in place along ``plan``
    (:func:`wire_plan`). ``names`` and ``segments`` name the tensors of the
    flat buffer and give their lengths, for their error-feedback residuals;
    without names (a joined rank's stand-in) no error feedback runs."""
    st = compression.state()
    flat = buf.view(-1)
    n = flat.numel()
    device = flat.device
    kind, link = plan
    lane = C._ps_label(process_set)
    tuner = st.tuner(lane)
    if kind == "hier":
        local, cross, L, Cs = _groups()
        piece_n = -(-n // (L * W.BLOCK)) * W.BLOCK
        inter, exploring = _pick(st, tuner, INTER, 4 * piece_n)
        first = inter or st.intra
    else:
        group = process_set.group()
        g, me = process_set.size(), dist.get_rank(group)
        codec, exploring = _pick(st, tuner, link, 4 * n)
        first = codec
    if names and st.ef_enabled and first:
        _error_feedback(flat, first, names, segments, lane)
    agree = process_set.group()
    if kind == "flat":
        _stage(st, tuner,
               lambda: _group_allreduce(flat, group, g, me, codec),
               exploring, device, agree, 4 * n, codec)
        return buf
    padded = piece_n * L
    work = flat if padded == n else torch.cat(
        [flat, flat.new_zeros(padded - n)])
    lr, cr = basics.local_rank(), basics.cross_rank()
    if st.intra:
        piece, _, _ = _reduce_scatter(work, local, L, lr, st.intra)
    else:
        piece = work.new_empty(piece_n)
        C._collective(dist.reduce_scatter_tensor, piece, work, group=local)
    _stage(st, tuner, lambda: _group_allreduce(piece, cross, Cs, cr, inter),
           exploring, device, agree, 4 * piece_n, inter)
    if st.intra:
        _allgather(piece, piece_n, [piece_n] * L, local, L, lr, st.intra,
                   work)
    else:
        C._collective(dist.all_gather_into_tensor, work, piece, group=local)
    if work is not flat:
        flat.copy_(work[:n])
    return buf
