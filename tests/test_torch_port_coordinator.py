"""The port's coordinator (``horovod_tpu_torch/ops/negotiation.py``)
against the JAX engine: the programs of ``tests/torch_port_coord_program.py``
(the mismatch programs of ``tests/test_engine_integration.py:120-129,
236-249, 434-446, 504-520, 552-567, 583`` and the other checks of the
engine's ``BuildResponse``) on a 5-process JAX-engine gang
(``libhvt_core.so``, through ``run_workers``) and on the port's 5-process
gloo gang, both launched with ``--stall-warning-sec 1``. Every rank must
raise the same exception class with the same message, the same sets must
be spared with the same values, both stall warnings must name the same
missing ranks (never the joined rank), and ``diagnostics()`` must carry the
same ``negotiations`` and ``stalls`` rows. Then the port's own: the stall
metric families, the requests a joined rank reads, and the checks alone."""

import json
import os
import re
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_engine_integration import LIB, run_workers  # noqa: E402
from torch_port_coord_program import TRANSPORTS  # noqa: E402

NP = 5
_WARN = re.compile(r"tensor '([^']+)' was submitted by some ranks but not by "
                   r"ranks \[ ([0-9 ]*)\] for \d+ s — possible stall")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _load(prefix):
    out = []
    for r in range(NP):
        with open(f"{prefix}.{r}.json") as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """((JAX results, JAX log), (port results, port log)); the port's gang
    is started first and collected after the JAX gang ran."""
    d = tmp_path_factory.mktemp("coord")
    port_out, jax_out = str(d / "port"), str(d / "jax")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(NP), "--master-port", str(_free_port()),
         "--stall-warning-sec", "1", sys.executable,
         os.path.join(REPO, "tests", "torch_port_coord_program.py"),
         port_out],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        if not os.path.exists(LIB):
            pytest.fail(f"the JAX engine is not built ({LIB})")
        jax_log = run_workers(f"""
            import json
            sys.path.insert(0, {os.path.join(REPO, 'tests')!r})
            import torch_port_coord_program as P
            from horovod_tpu.common.process_sets import ProcessSet
            res = P.matrix(hvt, lambda a: a, ProcessSet, {jax_out + '.gates'!r})
            with open(f"{jax_out}.{{r}}.json", "w") as f:
                json.dump(res, f)
        """, np=NP, timeout=180, launcher_args=("--stall-warning-sec", "1"))
        port_log, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, port_log[-4000:]
    return (_load(jax_out), jax_log), (_load(port_out), port_log)


def _in(port, transport):
    """Each rank's results in the world of ``transport``."""
    return [res[transport] for res in port]


def _section(log, transport):
    """The part of the port's log that the world of ``transport`` wrote."""
    parts = log.split("== transport ")
    return "".join(p for p in parts if p.startswith(transport + " =="))


def _same_cases(gangs, transport):
    (jax, _), (port, _) = gangs
    port = _in(port, transport)
    for r in range(NP):
        assert port[r]["cases"] == jax[r]["cases"], r


def test_every_rank_raises_the_engines_exception_and_message(gangs):
    """On the board (one host)."""
    _same_cases(gangs, "board")


def test_every_rank_raises_the_engines_exception_in_the_store(gangs):
    _same_cases(gangs, "store")


def test_the_mismatch_matrix_is_all_there(gangs):
    """Each program errs where the engine's tests say it errs, and the
    set spared is spared with the right sum; on the board and in the
    store."""
    _, (port, _) = gangs
    for transport in TRANSPORTS:
        by = [{tag: (cls, msg) for tag, cls, msg in res["cases"]}
              for res in _in(port, transport)]
        for tag, text in (("shape", "mismatched shape for tensor 'bad' "
                                    "([3] vs [2])"),
                          ("dtype", "mismatched dtype"),
                          ("reduce_op", "mismatched reduce op"),
                          ("root", "mismatched root rank"),
                          ("scales", "mismatched scale factors"),
                          ("op", "mismatched collective op"),
                          ("grouped_member", "(fusion group 1 aborted)"),
                          ("repeat_changed", "mismatched shape for tensor "
                                             "'rep'")):
            for r in range(NP):
                assert by[r][tag][0] == "ValueError" and \
                    text in by[r][tag][1], (transport, r, tag)
        for r in range(4):
            assert "conflicting process sets" in by[r]["set_conflict"][1]
            assert by[r]["grouped_set_conflict"][0] == "ValueError"
        assert by[2]["spared_set"] == by[3]["spared_set"] == \
            ("ok", [5.0, 5.0])
        assert by[3]["set_conflict_spares_disjoint"] == ("ok", [7.0, 7.0])
        for r in range(NP):
            assert by[r]["after"] == ("ok", [1.0, 1.0])
            assert by[r]["stalled"] == ("ok", "")
    _, (port, _) = gangs
    assert [res["board"]["on_board"] for res in port] == [True] * NP
    assert [res["store"]["on_board"] for res in port] == [False] * NP


def _warnings(log):
    """The stall warnings of the program's two stalled tensors (a loaded
    machine may make others too)."""
    return sorted({(m.group(1), m.group(2).strip())
                   for m in _WARN.finditer(log)
                   if m.group(1) in ("lonely", "lonely2")})


def test_the_stall_warning_names_the_same_ranks(gangs):
    (_, jax_log), (_, port_log) = gangs
    want = [("lonely", "0"), ("lonely2", "0")]   # never the joined rank 1
    assert _warnings(jax_log) == want
    for transport in TRANSPORTS:
        assert _warnings(_section(port_log, transport)) == want, transport


def test_diagnostics_rows_match_the_engine(gangs):
    (jax, _), (port, _) = gangs

    def rows(diag, key):
        return [{k: v for k, v in row.items() if k != "waiting_sec"}
                for row in diag[key]]

    for transport in TRANSPORTS:
        diag = _in(port, transport)[0]["diagnostics"]
        for key in ("negotiations", "stalls"):
            assert rows(diag, key) == rows(jax[0]["diagnostics"], key) == [
                {"tensor": "lonely", "op": "ALLREDUCE",
                 "arrived_ranks": [1, 2, 3, 4], "missing_ranks": [0]}]
            assert all(row["waiting_sec"] > 1.0 for row in diag[key])
        # the last joiners tie here (ranks 0, 2, 3 and 4 join together),
        # which each package breaks its own way: every rank must agree
        assert len({res["last_join"] for res in _in(port, transport)}) == 1


def test_calls_after_a_join_pair(gangs):
    _, (port, _) = gangs
    for transport in TRANSPORTS:
        assert [res["after_join"] for res in _in(port, transport)] == \
            [[10.0, 10.0]] * NP


def test_stall_metric_families(gangs):
    """The counter counts on across the two worlds of one process."""
    _, (port, _) = gangs
    for transport, total in (("board", 0.0), ("store", 2.0)):
        seen = _in(port, transport)[0]["during_stall"]
        after = _in(port, transport)[0]["after"]
        assert seen["missing_ranks"]["lonely"] == 1.0
        assert seen["stalls_total"] == total + 1.0
        assert after["stalls_total"] == total + 2.0
        assert after["missing_ranks"] == {"lonely": 0.0, "lonely2": 0.0}


def test_the_store_keeps_only_the_positions_in_flight(gangs):
    """10,000 negotiations on the global set leave the store's keys where
    they were, give or take the positions in flight and the last sweep:
    in the store a position's keys (one a member) go once every member
    has read it, on the board only what waited went to the store. 300
    async allreduces in flight together (past the board's window) sum
    right."""
    _, (port, _) = gangs
    for transport in TRANSPORTS:
        for r, res in enumerate(_in(port, transport)):
            keys = res["keys"]
            assert keys["async_sums_ok"], (transport, r)
            # kept, the records alone would be calls × NP = 50,000 keys;
            # the inspectors delete them a tenth of a second behind
            assert keys["peak"] - keys["before"] < \
                keys["calls"] * NP // 4, (transport, keys)
            assert keys["after"] - keys["before"] < 2 * 64 * NP, \
                (transport, keys)


def test_the_checks_alone_follow_the_engines_order():
    from horovod_tpu_torch.ops import negotiation as N

    def req(shape=(2,), op="allreduce", dtype="torch.float32", gid=-1):
        return (("t",), op, (dtype,), (shape,), "Sum", -1, 1.0, 1.0, gid,
                0 if gid < 0 else 1, None)

    assert N.check([req(), req()]) is None
    # the first field the engine compares wins: op before dtype and shape
    assert N.check([req(), req((3,), "allgather", "torch.int32")]) == \
        "mismatched collective op for tensor 't'"
    assert N.check([req((2, 3)), req((2, 4))]) == \
        "mismatched shape for tensor 't' ([2,4] vs [2,3])"
    assert N.check([req((2, 3), "allgather"), req((5, 3), "allgather")]) \
        is None
    assert N.check([req((2, 3), "alltoall"), req((2, 4), "alltoall")]) == \
        "mismatched non-leading dims for tensor 't'"
    assert N.check([req(gid=1), req((3,), gid=1)]).endswith(
        "(fusion group 1 aborted)")


def test_a_joined_rank_reads_the_active_ranks_request(monkeypatch):
    """What the join header carried, the request carries: the op, dtypes
    and shapes, reduce op or root, and an alltoall's splits."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import negotiation as N

    sent = []

    class _Coord:
        def set_state(self, ps):
            return N._Set("0", [0, 1])

        def post(self, st, req):
            sent.append(req)

    monkeypatch.setattr(N, "_coord", _Coord())
    gps = hvt.ProcessSet()
    N.post("allreduce", gps, torch.ones(3, 4, dtype=torch.bfloat16),
                reduce="Max")
    N.post("alltoall", gps, torch.ones(5, 2, 3), name="a",
                splits=[2, 3])
    N.post("broadcast", gps, torch.ones(7, dtype=torch.int32), root=1)
    N.post("allreduce", gps, [torch.ones(2), torch.ones(2, 2)],
                grouped=True, label="grouped_allreduce")
    assert sent == [
        (("hvt.allreduce.1",), "allreduce", ("torch.bfloat16",), ((3, 4),),
         "Max", -1, 1.0, 1.0, -1, 0, None),
        (("a",), "alltoall", ("torch.float32",), ((5, 2, 3),), "", -1, 1.0,
         1.0, -1, 0, (2, 3)),
        (("hvt.broadcast.1",), "broadcast", ("torch.int32",), ((7,),), "", 1,
         1.0, 1.0, -1, 0, None),
        (("hvt.grouped_allreduce.1", "hvt.grouped_allreduce.2"),
         "allreduce", ("torch.float32", "torch.float32"), ((2,), (2, 2)), "",
         -1, 1.0, 1.0, 1, 2, None)]
