"""hvt.join on the port against the JAX engine: the same ragged program
(``tests/torch_port_join_program.py``) on a 2-process JAX-engine gang
(``libhvt_core.so``, through ``run_workers`` of
``tests/test_engine_integration.py``) and on the port's 2-process gloo
gang: allreduce Sum and Average, an integer allreduce, allgather and
alltoall with a rank joined, join's return value, and the two liveness
pins (a repeat of a collective while the peer is joined; an async
collective submitted and then followed by join). Integers must be equal,
fp32 within rtol 1e-6. Then a DistributedOptimizer step with a rank joined
against one process, and join in a world of one."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_port_join_program as P  # noqa: E402
from test_engine_integration import LIB, run_workers  # noqa: E402

RTOL = 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX engine's per-rank results, the port's), the port's gang
    started first and collected after the JAX gang ran."""
    d = tmp_path_factory.mktemp("join")
    port_out, jax_out = str(d / "port"), str(d / "jax")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         "--master-port", str(_free_port()), sys.executable,
         os.path.join(REPO, "tests", "torch_port_join_program.py"),
         port_out],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        if not os.path.exists(LIB):
            pytest.fail(f"the JAX engine is not built ({LIB})")
        run_workers(f"""
            import json
            sys.path.insert(0, {os.path.join(REPO, 'tests')!r})
            import torch_port_join_program as P
            res = P.ragged(hvt, lambda a: a, np.asarray)
            with open(f"{jax_out}.{{r}}.json", "w") as f:
                json.dump(res, f)
        """, np=2, timeout=180)
        log, _ = proc.communicate(timeout=180)
    finally:
        proc.kill()
    assert proc.returncode == 0, log[-4000:]

    def load(prefix):
        out = []
        for r in range(2):
            with open(f"{prefix}.{r}.json") as f:
                out.append(json.load(f))
        return out

    return load(jax_out), load(port_out)


RAGGED_KEYS = ("sum_both", "avg_both", "sum_joined", "avg_joined",
               "int_sum_joined", "allgather_joined", "alltoall_joined",
               "alltoall_splits", "sum_repeat", "last_join",
               "async_then_join", "last_join_async")


@pytest.mark.parametrize("key", RAGGED_KEYS)
def test_port_gives_the_jax_engines_results(results, key):
    jax_res, port_res = results
    for r in range(2):
        want = jax_res[r].get(key)
        got = port_res[r].get(key)
        assert (want is None) == (got is None), (r, key, got, want)
        if want is None:
            continue
        want, got = np.asarray(want), np.asarray(got)
        assert got.shape == want.shape, (r, key, got, want)
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL)


def test_join_semantics_as_the_jax_engine_defines_them(results):
    """The values themselves: stand-ins are zeros, Average divides by the
    set's size, the joined rank sends no rows, the last rank to join is
    the same on every rank."""
    _, port = results
    r0 = port[0]
    assert r0["sum_joined"] == [1.0, 2.0, 3.0, 4.0]
    assert r0["avg_joined"] == [3.0] * 4
    assert r0["int_sum_joined"] == [7, 8, 9, 10]
    assert r0["allgather_joined"] == [[5.0] * 3] * 2
    assert r0["alltoall_joined"] == [[0.0, 1.0]]
    assert r0["alltoall_splits"] == [1, 0]
    assert r0["sum_repeat"] == [1.0] * 3
    for r in range(2):
        assert port[r]["last_join"] == 0
        assert port[r]["last_join_async"] == 0
        assert port[r]["async_then_join"] == [8.0] * 4
        assert port[r]["last_join_opt"] == 0
        assert not port[r]["diagnostics"]["joined"]
        assert port[r]["diagnostics"]["pending"] == []


def test_distributed_optimizer_step_with_a_rank_joined(results):
    """Rank 0's AdamW step through DistributedOptimizer while rank 1 is
    joined equals one process stepping on rank 0's gradient averaged with
    rank 1's zeros (the JAX engine's Average rule)."""
    _, port = results
    model = P.opt_model()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    x, y = (torch.from_numpy(a) for a in P.opt_batch())
    ((model(x) - y) ** 2).mean().backward()
    for p in model.parameters():
        p.grad /= 2
    opt.step()
    for got, want in zip(port[0]["params"], model.parameters()):
        np.testing.assert_allclose(np.asarray(got),
                                   want.detach().numpy(), rtol=RTOL,
                                   atol=1e-7)


@pytest.fixture()
def cpu_world():
    """A world of one process on gloo, shut down after the test."""
    import horovod_tpu_torch as hvt

    hvt.init(device="cpu")
    yield hvt
    hvt.shutdown()


def test_join_in_a_world_of_one_sends_no_header(cpu_world):
    """A world of one negotiates nothing: no coordinator runs, and join
    returns at once."""
    import horovod_tpu as jhvt

    from horovod_tpu_torch.ops import negotiation

    hvt = cpu_world
    jhvt.init()
    assert jhvt.join() == 0
    hvt.allreduce(torch.ones(2))
    hvt.barrier()
    assert hvt.join() == 0
    assert negotiation._coord is None and not hvt.diagnostics()["joined"]


def test_a_header_carries_the_collective_descriptor(cpu_world,
                                                   monkeypatch):
    """What a joined rank learns, now from the active ranks' requests in
    the negotiation that replaced the header: the op, dtype, reduce op or
    root, and the shape (whose rows an allgather or alltoall may vary);
    requests that differ raise the engine's error instead of a stand-in."""
    from horovod_tpu_torch.ops import negotiation as N

    hvt = cpu_world
    sent = []

    class _Coord:
        def set_state(self, ps):
            return N._Set("0", [0, 1])

        def post(self, st, req):
            sent.append(req)

    monkeypatch.setattr(N, "_coord", _Coord())
    gps = hvt.global_process_set
    N.post("allreduce", gps, torch.ones(3, 4, dtype=torch.bfloat16),
                name="x", reduce="Max")
    N.post("alltoall", gps, torch.ones(5, 2, 3), name="y",
                splits=[5, 0])
    N.post("broadcast", gps, torch.ones(7, dtype=torch.int32),
                name="z", root=1)
    N.post("barrier", gps, None, name="b")
    assert [(q[N.OP], q[N.DTYPES], q[N.SHAPES], q[N.REDUCE], q[N.ROOT])
            for q in sent] == [
        ("allreduce", ("torch.bfloat16",), ((3, 4),), "Max", -1),
        ("alltoall", ("torch.float32",), ((5, 2, 3),), "", -1),
        ("broadcast", ("torch.int32",), ((7,),), "", 1),
        ("barrier", ("",), ((),), "", -1)]
    out = N.Outcome([sent[1], None], [None, [3, 0]], 1, None, 0)
    assert out.recv_splits() == [0, 0] and out.rows() == [5, 0]
    other = sent[0][:N.SHAPES] + (((3, 5),),) + sent[0][N.SHAPES + 1:]
    assert N.check([sent[0], other]) == \
        "mismatched shape for tensor 'x' ([3,5] vs [3,4])"
