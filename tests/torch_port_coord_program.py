"""The coordinator's programs, on either package: ``matrix(hvt, T, ps,
gates)`` takes the package, a numpy-to-tensor function, a function that
gives the process set of a list of ranks and a directory for its gates,
and runs the cross-rank mismatch programs of
``tests/test_engine_integration.py`` (``:120-129`` shape, ``:434-446`` a
grouped member, ``:504-520`` overlapping sets, ``:552-567`` an error inside
one set sparing a disjoint one, ``:583`` a conflicted grouped call), the
other mismatches the engine checks (dtype, reduce op, root, scales, op, an
allgather's dims), a repeat (the engine's cache hit) whose shape then
changes, the stall (``:236-249``, with rank 0 late, its ``diagnostics()``
read meanwhile) and a stall with a joined rank. Each case gives this rank
``[tag, exception class or "ok", message]``. Ranks other than 0 reach each
mismatch after rank 0 does, so that the JAX engine meets rank 0's request
first, as the port always orders them: rank 0 opens a gate (a file in
``gates``) as it reaches a case, and the others wait for it, then a little
longer. The order so holds whatever the load on the machine (a sleep
alone let a rank 0 that was scheduled late post last). It imports neither
JAX nor torch.

As a script it is the port's worker (``python -m
horovod_tpu_torch.runner.launch -np N --stall-warning-sec 1 python
tests/torch_port_coord_program.py OUT [cpu|cuda]``): in a world whose
sets negotiate on the board and then in one where they all negotiate in
the store, it registers the sets the cases use, runs ``matrix`` and counts
the store's keys (:func:`store_keys`); it writes both worlds' results to
``OUT.<rank>.json``. On CUDA it also times the negotiation
(:func:`negotiation_cost`).
"""

import json
import os
import socket
import sys
import time

import numpy as np

LAG = 0.1           # how long after rank 0 the other ranks reach a mismatch
GATE_TIMEOUT = 120.0  # seconds a rank waits for rank 0's gate
LATE = 2.0          # how late rank 0 is for the stalled tensors
SETS = ([0, 1, 2], [1, 2, 3], [0, 1], [1, 2], [0, 2], [3, 4], [2, 3])
TRANSPORTS = ("board", "store")


def _pass_gate(gates, r, tag):
    """Rank 0 opens the gate of case ``tag`` (an empty file in the directory
    ``gates``); another rank returns once it is open."""
    path = os.path.join(gates, tag)
    if r == 0:
        os.makedirs(gates, exist_ok=True)
        open(path, "w").close()
        return
    deadline = time.monotonic() + GATE_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError(f"rank 0 never reached case {tag!r}")
        time.sleep(0.001)


def matrix(hvt, T, ps, gates, during_stall=None):
    """``gates``: a directory of this gang's own (see the module's
    docstring); ``during_stall(hvt)``, if given, runs on rank 0 while the
    others wait for it; its value is kept under ``during_stall``."""
    r, n = hvt.rank(), hvt.size()
    res = []

    def case(tag, fn, lag=LAG, keep=False):
        """``keep``: the result's values stand in for the message. With a
        ``lag``, rank 0 posts first (``_pass_gate``)."""
        if lag:
            _pass_gate(gates, r, tag)
            if r:
                time.sleep(lag)
        try:
            out = fn()
            res.append([tag, "ok", out.tolist() if keep else ""])
        except Exception as e:
            res.append([tag, type(e).__name__, str(e)])

    def z(shape, dtype=np.float32):
        return T(np.zeros(shape, dtype))

    def odd(a, b):      # rank 2's differs from everyone else's
        return b if r == 2 else a

    case("shape", lambda: hvt.allreduce(z(odd(2, 3)), name="bad"))
    case("shape_2d", lambda: hvt.allreduce(z((2, odd(2, 3))), name="bad2"))
    case("shape_unnamed", lambda: hvt.allreduce(z(odd(4, 5))))
    case("dtype", lambda: hvt.allreduce(
        z(2, odd(np.float32, np.float64)), name="dt"))
    case("reduce_op", lambda: hvt.allreduce(
        z(2), op=odd(hvt.Sum, hvt.Max), name="ro"))
    case("root", lambda: hvt.broadcast(z(2), root_rank=odd(0, 1),
                                       name="rt"))
    case("scales", lambda: hvt.allreduce(
        z(2), prescale_factor=odd(1.0, 2.0), name="sc"))
    case("op", lambda: odd(hvt.allreduce, hvt.allgather)(z(2), name="opx"))
    case("allgather_dims", lambda: hvt.allgather(z((2, odd(2, 3))),
                                                 name="agd"))
    case("allgather_ndim", lambda: hvt.allgather(
        z(odd((2, 2), (2,))), name="agn"))
    case("grouped_member", lambda: hvt.grouped_allreduce(
        [z(2), z(odd(2, 3)), z(2)], op=hvt.Sum, name="badgrp"))
    for i in range(3):
        case(f"repeat{i}", lambda: hvt.allreduce(z(2), name="rep"))
    case("repeat_changed", lambda: hvt.allreduce(z(odd(2, 3)), name="rep"))
    if n >= 4:
        conflict = ps([0, 1, 2]) if r < 2 else ps([1, 2, 3])
        if r < 4:
            case("set_conflict", lambda: hvt.allreduce(
                T(np.ones(2, np.float32)), name="mm",
                process_set=conflict))
            case("grouped_set_conflict", lambda: hvt.grouped_allreduce(
                [T(np.ones(2, np.float32)), T(np.ones(3, np.float32))],
                op=hvt.Sum, name="gg", process_set=conflict))
        if r < 2:
            case("set_error", lambda: hvt.allreduce(
                z(r + 2), name="t2", process_set=ps([0, 1])))
        elif r < 4:
            if r == 3:
                time.sleep(0.3)     # its entry waits while [0, 1] errs
            case("spared_set", lambda: hvt.allreduce(
                T(np.full(2, float(r), np.float32)), op=hvt.Sum, name="t2",
                process_set=ps([2, 3])), lag=0, keep=True)
    if n >= 5:
        sets = {0: [0, 1], 1: [1, 2], 2: [0, 2], 3: [3, 4], 4: [3, 4]}
        case("set_conflict_spares_disjoint", lambda: hvt.allreduce(
            T(np.full(2, float(r), np.float32)), op=hvt.Sum, name="t",
            process_set=ps(sets[r])), keep=True)
    case("after", lambda: hvt.allreduce(T(np.ones(2, np.float32)),
                                        name="after"), keep=True)
    diag = seen = None
    if r == 0:
        time.sleep(LATE)
        d = hvt.diagnostics()
        diag = {k: d.get(k) for k in ("negotiations", "stalls")}
        seen = during_stall(hvt) if during_stall else None
    case("stalled", lambda: hvt.allreduce(T(np.ones(2, np.float32)),
                                          name="lonely"), lag=0)
    if r == 1:
        last = int(hvt.join())
    else:
        if r == 0:
            time.sleep(LATE)
        case("stalled_beside_joined", lambda: hvt.allreduce(
            T(np.ones(2, np.float32)), name="lonely2"), lag=0)
        last = int(hvt.join())
    return {"cases": res, "diagnostics": diag, "last_join": last,
            "during_stall": seen}


def main(out_path, device):
    """Each case in a world on the board, then in a world where every set
    negotiates in the store: ``OUT.<rank>.json`` holds both."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import negotiation

    out = {}
    for transport in TRANSPORTS:
        if transport == "store":
            negotiation._BOARD_SETS = 0     # no set on the board
        hvt.init(device=device)
        if hvt.rank() == 0:
            print(f"== transport {transport} ==", flush=True)
        n = hvt.size()
        registered = {tuple(s): hvt.add_process_set(s) for s in SETS
                      if max(s) < n}
        dev = hvt.device()
        res = matrix(hvt, lambda a: torch.from_numpy(a).to(dev),
                     lambda ranks: registered[tuple(ranks)],
                     f"{out_path}.{transport}.gates", stall_metrics)
        res["after_join"] = after_join(hvt, dev)
        time.sleep(1.0)     # the inspector's next scans see the stalls end
        res["after"] = stall_metrics(hvt)
        res["on_board"] = negotiation._coord.set_state(
            hvt.global_process_set).board is not None
        res["keys"] = store_keys(hvt, dev)
        if dev.type == "cuda":
            res["negotiation_cost"] = negotiation_cost(hvt)
        out[transport], rank = res, hvt.rank()
        # the next world on a port of its own, as an elastic round's
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = hvt.broadcast_object(sock.getsockname()[1])
        host = os.environ["HVT_COORDINATOR_ADDR"].rsplit(":", 1)[0]
        os.environ["HVT_COORDINATOR_ADDR"] = f"{host}:{port}"
        hvt.shutdown()
    with open(f"{out_path}.{rank}.json", "w") as f:
        json.dump(out, f)


def store_keys(hvt, dev, calls=10000):
    """The keys of the process group's store while this world negotiates
    ``calls`` collectives on the global set (every tenth an allgather of a
    rank's own rows), sampled every 500 calls, then 300 async allreduces in
    flight together (past the board's window), and after the inspectors'
    next sweep: only the positions in flight and the last few read stay."""
    import torch

    from horovod_tpu_torch.ops import negotiation

    store = negotiation._coord.tcp
    gps = hvt.global_process_set
    x, rows = torch.zeros(4), torch.zeros(hvt.rank() + 1, 2)
    before = peak = store.num_keys()
    for i in range(calls):
        if i % 10:
            negotiation.negotiate("allreduce", gps, x, name=f"k{i % 7}",
                                  reduce="Sum")
        else:
            negotiation.negotiate("allgather", gps, rows, name="rows")
        if i % 500 == 499:
            peak = max(peak, store.num_keys())
    handles = [hvt.allreduce_async_(torch.ones(2, device=dev), op=hvt.Sum,
                                    name=f"a{i}") for i in range(300)]
    n = float(hvt.size())
    sums_ok = all(hvt.synchronize(h).tolist() == [n, n] for h in handles)
    hvt.barrier()
    time.sleep(1.0)
    after = store.num_keys()
    hvt.barrier()       # no rank leaves the world while one reads its store
    return {"before": before, "peak": peak, "after": after, "calls": calls,
            "async_sums_ok": sums_ok}


def after_join(hvt, dev):
    """Rank 1 joins while the others make a grouped and an unnamed call;
    then every rank makes an unnamed grouped allreduce, which must pair:
    the joined rank took the others' counts of grouped calls and unnamed
    tensors. The port's own case (the JAX engine's counts stay apart)."""
    import torch

    r = hvt.rank()
    if r == 1:
        hvt.join()
    else:
        hvt.grouped_allreduce([torch.ones(2, device=dev)], name="gj")
        hvt.allreduce(torch.ones(2, device=dev))
        hvt.join()
    out = hvt.grouped_allreduce([torch.full((2,), float(r), device=dev)],
                                op=hvt.Sum)
    return out[0].tolist()


def stall_metrics(hvt):
    """The stall inspector's two families on this rank."""
    reg = hvt.metrics.registry()
    total = reg.get("hvt_engine_stalls_total")
    gauge = reg.get("hvt_stall_missing_ranks")
    return {"stalls_total": total.value if total else None,
            "missing_ranks": {labels["tensor"]: child.value
                              for labels, child in gauge.samples()}
            if gauge else None}


def negotiation_cost(hvt, calls=200):
    """Host µs a call of: one look at the store (a round trip to rank 0's
    server); the negotiation alone, of one request repeated (one name) and
    of a new name each call; a 1 KiB in-place allreduce through
    torch.distributed alone, and through hvt with each negotiation. Behind
    a barrier, on a synchronized card."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops import negotiation

    x = torch.zeros(256, device=hvt.device())
    gps = hvt.global_process_set
    seq = iter(range(10 ** 9))
    store = negotiation._coord.store()
    calls_by = {
        "store_round_trip": lambda: store.check(["cost"]),
        "negotiate_repeat": lambda: negotiation.negotiate(
            "allreduce", gps, x, name="cost", reduce="Sum"),
        "negotiate_new": lambda: negotiation.negotiate(
            "allreduce", gps, x, name=f"cost.{next(seq)}", reduce="Sum"),
        "torch_distributed": lambda: dist.all_reduce(x),
        "hvt_repeat": lambda: hvt.allreduce_(x, op=hvt.Sum, name="c1"),
        "hvt_new": lambda: hvt.allreduce_(x, op=hvt.Sum,
                                           name=f"c.{next(seq)}")}
    out = {}
    for name, call in calls_by.items():
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        hvt.barrier()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        host = (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        out[name] = host * 1e6
    return out


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "cpu")
