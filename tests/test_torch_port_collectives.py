"""horovod_tpu_torch collectives and DistributedOptimizer across processes.

A 2-process gloo gang, started through the hvtrun identity env (HVT_*),
is held against the JAX package's traced allreduce under shard_map on 2 CPU
devices with the same per-rank inputs, and a 2-rank data-parallel step on
half-batches against the 1-process full-batch step. The same gang checks
the gradients of allreduce and allgather against numpy, that a rank with an
unused parameter still steps (its zeros take part in the reduction), and
that synchronize() then step() inside skip_synchronize() reduces once; in a
world of one, the gradients of all five out-of-place collectives are held
against jax.grad of the JAX package's traced ops.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvt
import horovod_tpu_torch as hvt
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.train import make_train_step, seeded_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4, d_ff=512,
             max_seq_len=128, dtype=torch.float32)
# (op name, prescale, postscale)
CASES = [("Average", 1.0, 1.0), ("Sum", 1.0, 1.0), ("Min", 1.0, 1.0),
         ("Max", 1.0, 1.0), ("Product", 1.0, 1.0), ("Average", 0.5, 3.0),
         ("Sum", 2.0, 0.25)]
DP_STEPS, DP_BATCH = 2, 2          # per rank; the baseline takes 2 × 2 rows

WORKER = r"""
import json, os, sys, warnings
import numpy as np
import torch
import horovod_tpu_torch as hvt
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.train import make_train_step, seeded_tokens

cases, entry, steps, batch, out = json.loads(sys.argv[1])
hvt.init(device="cpu")
r = hvt.rank()
x = torch.from_numpy(np.random.RandomState(7).normal(
    size=(hvt.size(), 3, 5)).astype(np.float32)[r])
res = {"rank": r, "size": hvt.size(), "local_rank": hvt.local_rank(),
       "cross_size": hvt.cross_size(), "allreduce": []}
for op, pre, post in cases:
    y = hvt.allreduce(x, op=getattr(hvt, op), prescale_factor=pre,
                      postscale_factor=post)
    res["allreduce"].append(y.tolist())
res["alias"] = hvt.allreduce(x, average=False).tolist()
ints = torch.tensor([2 * r, 2 * r + 1], dtype=torch.int32)
avg = hvt.allreduce(ints)
res["int_average"] = [str(avg.dtype), avg.tolist()]
try:
    hvt.allreduce_(ints)
    res["int_average_inplace"] = "no error"
except TypeError as e:
    res["int_average_inplace"] = type(e).__name__
res["broadcast"] = hvt.broadcast(x, root_rank=1).tolist()
# gradients through the collectives: Average with a prescale, and a ragged
# allgather (rank r gives r + 1 rows)
w = torch.arange(15, dtype=torch.float32).reshape(3, 5) + r
xg = x.clone().requires_grad_()
(hvt.allreduce(xg, op=hvt.Average, prescale_factor=3.0) * w).sum().backward()
res["grad_allreduce"] = xg.grad.tolist()
xg = x[:r + 1].clone().requires_grad_()
gathered = hvt.allgather(xg)
(gathered * torch.arange(gathered.numel(), dtype=torch.float32)
 .reshape(gathered.shape) * (r + 1)).sum().backward()
res["grad_allgather"] = xg.grad.tolist()
# rank 1 leaves b unused: its zeros take part in the fused reduction
a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
opt = hvt.DistributedOptimizer(torch.optim.SGD([a, b], lr=0.5))
loss = (a * (r + 1)).sum() + ((b * 2).sum() if r == 0 else 0)
loss.backward()
opt.step()
res["unused"] = [a.tolist(), b.tolist()]
# synchronize(), then step() inside skip_synchronize(): one reduction; a
# plain step() after synchronize() warns and reduces again
res["skip_sync"] = []
for skip in (True, False):
    v = torch.nn.Parameter(torch.ones(1))
    opt = hvt.DistributedOptimizer(torch.optim.SGD([v], lr=1.0), op=hvt.Sum)
    v.grad = torch.full((1,), float(r + 1))
    opt.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if skip:
            with opt.skip_synchronize():
                opt.step()
        else:
            opt.step()
    res["skip_sync"].append([v.item(), len(caught)])
hvt.barrier()
entry["dtype"] = torch.float32
cfg = GPTConfig(**entry)
model = GPT(cfg, device="cpu", seed=0)
opt = hvt.DistributedOptimizer(torch.optim.AdamW(
    model.parameters(), lr=1e-3, weight_decay=1e-4))
step = make_train_step(model, opt)
tokens = seeded_tokens(cfg, batch, 32, seed=0)
res["losses"] = [float(step(tokens)) for _ in range(steps)]
if r == 0:
    torch.save(model.state_dict(), out + ".pt")
hvt.barrier()
if r == 1:                        # a peer lost mid-job
    with open(out + ".1.json", "w") as f:
        json.dump(res, f)
    os._exit(0)
try:
    hvt.allreduce(x)
    res["lost_peer"] = "no error"
except hvt.HorovodInternalError as e:
    res["lost_peer"] = type(e).__name__
with open(out + ".0.json", "w") as f:
    json.dump(res, f)
os._exit(0)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Run the worker on 2 processes; return (per-rank results, rank 0's
    final state_dict)."""
    out = str(tmp_path_factory.mktemp("gang") / "res")
    entry = {k: v for k, v in ENTRY.items() if k != "dtype"}
    arg = json.dumps([CASES, entry, DP_STEPS, DP_BATCH, out])
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, HVT_PROCESS_ID=str(r),
                   HVT_NUM_PROCESSES="2", HVT_LOCAL_PROCESS_ID=str(r),
                   HVT_LOCAL_SIZE="2", HVT_CROSS_RANK="0",
                   HVT_CROSS_SIZE="1",
                   HVT_COORDINATOR_ADDR=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, arg], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    results = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            results.append(json.load(f))
    return results, torch.load(out + ".pt")


def _jax_allreduce(x, op, pre, post):
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    fn = jax.shard_map(
        lambda t: jhvt.allreduce(t, op=getattr(jhvt, op), axis_name="x",
                                 prescale_factor=pre,
                                 postscale_factor=post),
        mesh=mesh, in_specs=P("x"), out_specs=P("x"))
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


def test_gang_topology(gang):
    results, _ = gang
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["size"] == 2 and r["cross_size"] == 1 for r in results)
    assert [r["local_rank"] for r in results] == [0, 1]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{op}-pre{a}-post{b}" for op, a, b in CASES])
def test_allreduce_matches_jax_traced(gang, i):
    results, _ = gang
    op, pre, post = CASES[i]
    x = np.random.RandomState(7).normal(size=(2, 3, 5)).astype(np.float32)
    want = _jax_allreduce(x.reshape(6, 5), op, pre, post).reshape(2, 3, 5)
    for r in range(2):
        np.testing.assert_allclose(np.asarray(results[r]["allreduce"][i]),
                                   want[r], rtol=1e-6, atol=1e-6)


def test_integer_average_gives_the_float_mean_as_jax_does(gang):
    """int32 [0, 1, 2, 3] split over two ranks: the JAX traced allreduce
    (Average) gives the float mean on each shard, and so does the port's
    out-of-place allreduce; the in-place form cannot hold it and raises."""
    results, _ = gang
    ints = np.arange(4, dtype=np.int32)
    want = _jax_allreduce(ints, "Average", 1.0, 1.0)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(want, [1.0, 2.0, 1.0, 2.0])
    for r in range(2):
        dtype, got = results[r]["int_average"]
        assert dtype == "torch.float32"
        np.testing.assert_array_equal(got, want[2 * r:2 * r + 2])
        assert results[r]["int_average_inplace"] == "TypeError"


def test_collective_gradients_match_numpy(gang):
    """allreduce (Average, prescale 3): each rank's gradient is 3/2 of the
    sum of the ranks' cotangents. allgather of 1 and 2 rows: rank r's rows
    of the cotangents summed over ranks ((1 + 2) times the row weights)."""
    results, _ = gang
    x = np.random.RandomState(7).normal(size=(2, 3, 5)).astype(np.float32)
    w = np.arange(15, dtype=np.float32).reshape(3, 5)
    rows = np.arange(15, dtype=np.float32).reshape(3, 5)
    for r in range(2):
        np.testing.assert_allclose(results[r]["grad_allreduce"],
                                   1.5 * (2 * w + 1), rtol=1e-6)
        mine = rows[r:2 * r + 1] if r else rows[:1]
        np.testing.assert_allclose(results[r]["grad_allgather"], 3 * mine,
                                   rtol=1e-6)
        assert np.asarray(results[r]["grad_allgather"]).shape == \
            x[r, :r + 1].shape


def test_unused_parameter_steps_on_every_rank(gang):
    """Rank 1 never uses b: it reduces zeros for it, so both ranks fuse
    buffers of one size and step b by the average (2 + 0) / 2."""
    results, _ = gang
    for r in range(2):
        a, b = results[r]["unused"]
        np.testing.assert_allclose(a, [1 - 0.5 * 1.5] * 3, rtol=1e-6)
        np.testing.assert_allclose(b, [1 - 0.5 * 1.0] * 2, rtol=1e-6)


def test_skip_synchronize_reduces_once(gang):
    """op=Sum, SGD lr 1, gradients 1 and 2: one reduction moves the
    parameter 1 → -2; without skip_synchronize() step() reduces the summed
    gradient again (1 → -5) and warns, as the torch binding does."""
    results, _ = gang
    for r in range(2):
        assert results[r]["skip_sync"] == [[-2.0, 0], [-5.0, 1]]


def test_lost_peer_raises_horovod_internal_error(gang):
    results, _ = gang
    assert results[0]["lost_peer"] == "HorovodInternalError"


def test_average_alias_and_broadcast(gang):
    results, _ = gang
    x = np.random.RandomState(7).normal(size=(2, 3, 5)).astype(np.float32)
    for r in range(2):
        np.testing.assert_allclose(results[r]["alias"], x.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(results[r]["broadcast"], x[1])


def test_two_rank_dp_step_equals_full_batch_step(gang):
    """Average of the half-batch gradients is the full-batch gradient, so
    two DP steps equal two 1-process steps on the whole batch (tolerances as
    in test_torch_port_train.py)."""
    results, dp_state = gang
    hvt.init(device="cpu")
    try:
        cfg = GPTConfig(**ENTRY)
        model = GPT(cfg, device="cpu", seed=0)
        opt = hvt.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-3, weight_decay=1e-4))
        step = make_train_step(model, opt)
        tokens = seeded_tokens(cfg, 2 * DP_BATCH, 32, seed=0)
        losses = [float(step(tokens)) for _ in range(DP_STEPS)]
    finally:
        hvt.shutdown()
    dp_losses = np.mean([r["losses"] for r in results], axis=0)
    np.testing.assert_allclose(dp_losses, losses, rtol=1e-4, atol=1e-5)
    for name, want in model.state_dict().items():
        np.testing.assert_allclose(dp_state[name].numpy(), want.numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


def test_optimizer_options_in_a_world_of_one():
    hvt.init(device="cpu")
    try:
        w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
        opt = hvt.DistributedOptimizer(
            torch.optim.SGD([w], lr=0.1), compression=hvt.Compression.fp16,
            gradient_predivide_factor=4.0)
        assert isinstance(opt, torch.optim.SGD)
        w.grad = torch.tensor([1.0 / 3.0, 0.5])
        opt.synchronize()
        want = torch.tensor([1.0 / 3.0, 0.5]).half().float()
        torch.testing.assert_close(w.grad, want, rtol=1e-3, atol=1e-3)
        assert w.grad.dtype == torch.float32
        with pytest.raises(ValueError, match="Average"):
            hvt.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                     op=hvt.Sum,
                                     gradient_predivide_factor=2.0)
        # backward_passes_per_step: the first pass only accumulates
        opt = hvt.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                       backward_passes_per_step=2)
        for g in (1.0, 3.0):
            w.grad = torch.full((2,), g)
            opt.step()
            if g == 1.0:
                torch.testing.assert_close(w.detach(),
                                           torch.tensor([1.0, 2.0]))
        torch.testing.assert_close(w.detach(), torch.tensor([0.6, 1.6]))
        # reduce_filter: a filtered-out parameter skips the collective
        v = torch.nn.Parameter(torch.zeros(2))
        opt = hvt.DistributedOptimizer(
            torch.optim.SGD([w, v], lr=0.1), [("w", w), ("v", v)],
            op=hvt.Sum, prescale_factor=2.0,
            reduce_filter=lambda name: name != "v")
        w.grad, v.grad = torch.ones(2), torch.ones(2)
        opt.synchronize()
        torch.testing.assert_close(w.grad, torch.full((2,), 2.0))
        torch.testing.assert_close(v.grad, torch.ones(2))
        # Adasum in a world of one returns the gradient unchanged
        opt = hvt.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                       op=hvt.Adasum)
        w.grad = torch.tensor([0.25, -4.0])
        opt.synchronize()
        torch.testing.assert_close(w.grad, torch.tensor([0.25, -4.0]))
        x = torch.tensor([1.5, -2.0])
        torch.testing.assert_close(hvt.allreduce(x, op=hvt.Adasum), x)
        ps = hvt.add_process_set([0])
        assert ps.process_set_id == 1 and ps.included()
        torch.testing.assert_close(hvt.allreduce(x, process_set=ps), x)
        hvt.remove_process_set(ps)
        assert ps.process_set_id is None
    finally:
        hvt.shutdown()
    with pytest.raises(ValueError, match="init"):
        hvt.size()


PORT_CALLS = {"allreduce": lambda x: hvt.allreduce(x),
              "allgather": lambda x: hvt.allgather(x),
              "broadcast": lambda x: hvt.broadcast(x, root_rank=0),
              "alltoall": lambda x: hvt.alltoall(x),
              "reducescatter": lambda x: hvt.reducescatter(x)}
JAX_CALLS = {"allreduce": lambda t: jhvt.allreduce(t, axis_name="x"),
             "allgather": lambda t: jhvt.allgather(t, axis_name="x"),
             "broadcast": lambda t: jhvt.broadcast(t, 0, axis_name="x"),
             "alltoall": lambda t: jhvt.alltoall(t, axis_name="x"),
             "reducescatter": lambda t: jhvt.reducescatter(t, axis_name="x")}


@pytest.mark.parametrize("op", sorted(PORT_CALLS))
def test_collective_gradient_in_a_world_of_one_matches_jax(op):
    """x = arange(4): the gradient of (op(x) * arange(4)).sum() is
    [0, 1, 2, 3] under jax.grad of the JAX package's traced op on a
    one-device mesh, and in the port's world of one process (exact)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    fn = jax.shard_map(JAX_CALLS[op], mesh=mesh, in_specs=P("x"),
                       out_specs=P("x"))
    want = np.asarray(jax.grad(lambda t: (fn(t) * jnp.arange(4.0)).sum())(
        jnp.arange(4.0)))
    np.testing.assert_array_equal(want, np.arange(4.0))
    hvt.init(device="cpu")
    try:
        x = torch.arange(4.0, requires_grad=True)
        (PORT_CALLS[op](x) * torch.arange(4.0)).sum().backward()
    finally:
        hvt.shutdown()
    np.testing.assert_array_equal(x.grad.numpy(), want)
