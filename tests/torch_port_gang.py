"""A gang of horovod_tpu_torch processes that drives every collective of the
port once, shared by the gloo test (tests/test_torch_port_collectives4.py)
and the NCCL test (tests/test_torch_port_cuda.py). Imports no JAX, so the
card test can use it where JAX is missing.

``run_gang(n, local_size, device, out)`` starts ``n`` processes through the
hvtrun identity env (ranks host-major: local rank r % local_size, cross
rank r // local_size) and returns each rank's results. On CUDA each fake
host's processes see only that host's slice of the cards the caller was
given (its ``CUDA_VISIBLE_DEVICES``), as on separate machines, so local
rank i drives the host's i-th card. ``inputs(n)`` gives
the per-rank numpy inputs the worker reads and ``expected(n, local_size)``
the numpy value of each call, rank by rank.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny GPT of the accumulation step: the __graft_entry__ model
ENTRY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4, d_ff=512,
             max_seq_len=128)
ACC_UPDATES, ACC_ROWS, ACC_SEQ = 2, 2, 32     # rows per rank, 1 per pass
LOCAL_LAYERS = ("attn/q",)
TIMEOUT_SLEEP_S = 1.5


def sets(n):
    """The two process sets the worker registers, in order."""
    return [[0, 1], list(range(n - 1))]


def splits(n, r):
    """Rank r's uneven alltoall send counts."""
    return [(r + j) % 3 for j in range(n)]


def sparse_rows(n, r):
    """Rank r's sparse row indices (duplicates on purpose)."""
    return [r % 2] + [3] * (r % 3)


def inputs(n):
    """Per-rank numpy inputs, indexed [rank]."""
    rs = np.random.RandomState(11)
    x = rs.normal(size=(n, 2 * n, 3)).astype(np.float32)
    y = rs.normal(size=(n, 5)).astype(np.float32)
    z = rs.randint(-50, 50, size=(n, 3)).astype(np.int32)
    rag = rs.normal(size=(n, n, 3)).astype(np.float32)
    a2a = rs.normal(size=(n, 2 * n, 2)).astype(np.float32)
    # Adasum inputs of different scales, so the combine is not an average
    scale = (1.0 + np.arange(n, dtype=np.float32))[:, None, None]
    ada = rs.normal(size=(n, 5, 4)).astype(np.float32) * scale
    ada2 = rs.normal(size=(n, 7)).astype(np.float32)
    hier = rs.normal(size=(n, 3, 5)).astype(np.float32)
    sp = rs.normal(size=(n, 3, 2)).astype(np.float32)
    # bf16 cases hold small integers, so their sums are exact
    ints = rs.randint(-8, 8, size=(n, 6)).astype(np.float32)
    return dict(x=x, y=y, z=z, rag=rag, a2a=a2a, ada=ada, ada2=ada2,
                hier=hier, sp=sp, ints=ints)


def adasum_np(vs, start_level=1):
    """Adasum of the list ``vs`` (power-of-two length) in float64: every
    member's result, which is the same for all of them."""
    v = [np.asarray(a, np.float64).reshape(-1) for a in vs]
    stride = 1
    while stride < len(v):
        nxt = []
        for i, a in enumerate(v):
            b = v[i ^ stride]
            if stride < start_level:
                nxt.append(0.5 * (a + b))
                continue
            dot, aa, bb = a @ b, a @ a, b @ b
            ca = 1.0 - dot / (2 * aa) if aa > 0 else 1.0
            cb = 1.0 - dot / (2 * bb) if bb > 0 else 1.0
            nxt.append(ca * a + cb * b)
        v, stride = nxt, stride * 2
    return v[0].reshape(np.shape(vs[0]))


def expected(n, local_size):
    """The numpy value of each call the worker makes, as {key: [per rank]}
    (None where the rank does not take part)."""
    d = inputs(n)
    x, rag, a2a = d["x"], d["rag"], d["a2a"]
    every = lambda v: [v] * n          # noqa: E731
    out = {}
    out["allgather"] = every(x.reshape(-1, 3))
    out["allgather_ragged"] = every(np.concatenate(
        [rag[r][:r + 1] for r in range(n)]))
    out["allgather_int"] = every(np.concatenate(
        [d["z"][r][:r + 1] for r in range(n)]))
    out["allgather_bf16"] = every(np.concatenate(
        [d["ints"][r][:r + 1] for r in range(n)]))
    out["alltoall"] = [np.concatenate([x[j][2 * r:2 * r + 2]
                                       for j in range(n)]) for r in range(n)]
    recv = []
    for r in range(n):
        parts, splits_r = [], []
        for j in range(n):
            s = splits(n, j)
            off = sum(s[:r])
            parts.append(a2a[j][off:off + s[r]])
            splits_r.append(s[r])
        recv.append((np.concatenate(parts), splits_r))
    out["alltoall_splits"] = [v for v, _ in recv]
    out["alltoall_recv_splits"] = [s for _, s in recv]
    out["reducescatter_avg"] = [x.mean(0)[2 * r:2 * r + 2] for r in range(n)]
    out["reducescatter_sum_scaled"] = [
        3.0 * (0.5 * x).sum(0)[2 * r:2 * r + 2] for r in range(n)]
    out["grouped_reducescatter"] = [
        [x.sum(0)[2 * r:2 * r + 2], (2 * x).sum(0)[2 * r:2 * r + 2]]
        for r in range(n)]
    out["grouped_allreduce"] = every([x.mean(0), d["y"].mean(0),
                                      d["z"].astype(np.float64).mean(0)])
    out["allreduce_bf16"] = every(d["ints"].sum(0))
    for k, s in enumerate(sets(n)):
        out[f"set{k}_avg"] = [x[s].mean(0) if r in s else None
                              for r in range(n)]
        out[f"set{k}_sum"] = [x[s].sum(0) if r in s else None
                              for r in range(n)]
    s1 = sets(n)[1]
    out["set1_broadcast"] = [x[max(s1)] if r in s1 else None
                             for r in range(n)]
    ada = d["ada"]
    for lvl in (1, 2):
        out[f"adasum_world_l{lvl}"] = every(adasum_np(list(ada), lvl))
        pair = adasum_np([ada[0], ada[1]], lvl)
        out[f"adasum_set0_l{lvl}"] = [pair if r < 2 else None
                                      for r in range(n)]
    out["adasum_allreduce"] = every(adasum_np(list(ada)))
    out["adasum_grouped"] = every([adasum_np(list(ada)),
                                   adasum_np(list(d["ada2"]))])
    out["hier_sum"] = every(d["hier"].sum(0))
    out["hier_avg"] = every(d["hier"].mean(0))
    out["hier_allgather"] = every(d["hier"][:, :2].reshape(-1, 5))
    out["async_allreduce"] = every(x.mean(0))
    out["async_grouped"] = every([x.sum(0), d["y"].sum(0)])
    out["async_allgather"] = out["allgather_ragged"]
    out["async_broadcast"] = every(x[1])
    out["async_alltoall"] = out["alltoall_splits"]
    out["timeout"] = [["HorovodTimeoutError", False, [3.0, 3.0]]
                      if r == 0 else None for r in range(n)]
    for avg in (True, False):
        dense = np.zeros((5, 2), np.float64)
        for r in range(n):
            rows = sparse_rows(n, r)
            np.add.at(dense, rows, d["sp"][r][:len(rows)] / (n if avg else 1))
        out[f"sparse_avg{int(avg)}"] = every(dense)
    out["set0_predivide"] = [x[:2].mean(0) if r < 2 else None
                             for r in range(n)]
    return out


WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.path.join(os.environ["PYTHONPATH"], "tests"))
import torch_port_gang as G
import horovod_tpu_torch as hvt
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.train import loss_fn, make_train_step, seeded_tokens

device, out = json.loads(sys.argv[1])
hvt.init(device=device)
n, r = hvt.size(), hvt.rank()
dev = hvt.device()
D = {k: torch.from_numpy(v[r]).to(dev) for k, v in G.inputs(n).items()}
res = {}


def enc(t):
    if isinstance(t, (list, tuple)):
        return [enc(v) for v in t]
    assert t.device == dev or t.device.type == "cpu", t.device
    return {"dtype": str(t.dtype), "data": t.float().cpu().tolist()
            if t.dtype == torch.bfloat16 else t.cpu().tolist()}


def error_of(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return "no error"


x, rag, a2a = D["x"], D["rag"], D["a2a"]
res["allgather"] = enc(hvt.allgather(x))
res["allgather_ragged"] = enc(hvt.allgather(rag[:r + 1]))
res["allgather_int"] = enc(hvt.allgather(D["z"][:r + 1]))
res["allgather_bf16"] = enc(hvt.allgather(D["ints"][:r + 1].bfloat16()))
res["grouped_allgather"] = enc(hvt.grouped_allgather([x, rag[:r + 1]]))
res["alltoall"] = enc(hvt.alltoall(x))
got, recv = hvt.alltoall(a2a[:sum(G.splits(n, r))], splits=G.splits(n, r))
res["alltoall_splits"], res["alltoall_recv_splits"] = enc(got), recv.tolist()
res["reducescatter_avg"] = enc(hvt.reducescatter(x))
res["reducescatter_sum_scaled"] = enc(hvt.reducescatter(
    x, op=hvt.Sum, prescale_factor=0.5, postscale_factor=3.0))
res["reducescatter_bad"] = error_of(lambda: hvt.reducescatter(x[:-1]))
res["grouped_reducescatter"] = enc(hvt.grouped_reducescatter([x, 2 * x],
                                                             op=hvt.Sum))
res["grouped_allreduce"] = enc(hvt.grouped_allreduce([x, D["y"], D["z"]]))
res["allreduce_bf16"] = enc(hvt.allreduce(D["ints"].bfloat16(), op=hvt.Sum))

# process sets: registered by every rank, used by members only
ps = [hvt.add_process_set(s) for s in G.sets(n)]
res["set_ids"] = [p.process_set_id for p in ps]
res["set_again"] = hvt.add_process_set(G.sets(n)[0]).process_set_id
res["set_ranks"] = [hvt.process_set_included_ranks(p.process_set_id)
                    for p in ps]
res["included"] = [p.included() for p in ps]
for k, p in enumerate(ps):
    if p.included():
        res[f"set{k}_avg"] = enc(hvt.allreduce(x, process_set=p))
        res[f"set{k}_sum"] = enc(hvt.allreduce(x, op=hvt.Sum, process_set=p))
        hvt.barrier(process_set=p)
    else:
        res[f"set{k}_nonmember"] = error_of(
            lambda: hvt.allreduce(x, process_set=p))
root = max(G.sets(n)[1])
if ps[1].included():
    res["set1_broadcast"] = enc(hvt.broadcast(x, root_rank=root,
                                              process_set=ps[1]))
res["broadcast_root_not_member"] = error_of(
    lambda: hvt.broadcast(x, root_rank=n - 1, process_set=ps[1]))

# Adasum
ada = D["ada"]
for lvl in (1, 2):
    res[f"adasum_world_l{lvl}"] = enc(hvt.adasum_reduce(ada, start_level=lvl))
    if ps[0].included():
        res[f"adasum_set0_l{lvl}"] = enc(hvt.adasum_reduce(
            ada, process_set=ps[0], start_level=lvl))
res["adasum_allreduce"] = enc(hvt.allreduce(ada, op=hvt.Adasum))
res["adasum_grouped"] = enc(hvt.grouped_allreduce([ada, D["ada2"]],
                                                  op=hvt.Adasum))
if ps[1].included() and len(G.sets(n)[1]) & (len(G.sets(n)[1]) - 1):
    res["adasum_not_pow2"] = error_of(
        lambda: hvt.allreduce(ada, op=hvt.Adasum, process_set=ps[1]))

# hierarchical
res["hier_sum"] = enc(hvt.hierarchical_allreduce(D["hier"]))
res["hier_avg"] = enc(hvt.hierarchical_allreduce(D["hier"], average=True))
res["hier_allgather"] = enc(hvt.hierarchical_allgather(D["hier"][:2]))

# async handles
hs = {"async_allreduce": hvt.allreduce_async(x),
      "async_grouped": hvt.grouped_allreduce_async([x, D["y"]], op=hvt.Sum),
      "async_allgather": hvt.allgather_async(rag[:r + 1]),
      "async_broadcast": hvt.broadcast_async(x, root_rank=1),
      "async_alltoall": hvt.alltoall_async(a2a[:sum(G.splits(n, r))],
                                           splits=G.splits(n, r))}
res["poll_types"] = sorted({type(hvt.poll(h)).__name__ for h in hs.values()})
for k, h in hs.items():
    v = hvt.synchronize(h)
    res[k] = enc(v[0] if k == "async_alltoall" else v)
    res[k + "_again"] = hvt.poll(h)
if ps[0].included():
    if r == 1:
        time.sleep(G.TIMEOUT_SLEEP_S)      # rank 0 waits on a late peer
    h = hvt.allreduce_async(torch.full((2,), float(r + 1), device=dev),
                            op=hvt.Sum, process_set=ps[0])
    if r == 0:
        polled = hvt.poll(h)
        try:
            hvt.synchronize(h, timeout=0.2)
            timed_out = "no error"
        except hvt.HorovodTimeoutError as e:
            timed_out = type(e).__name__
        res["timeout"] = [timed_out, polled, hvt.synchronize(h).tolist()]
    else:
        hvt.synchronize(h)

# sparse
rows = G.sparse_rows(n, r)
idx = torch.tensor(rows, device=dev)
for avg in (True, False):
    res[f"sparse_avg{int(avg)}"] = enc(hvt.sparse_allreduce_apply(
        torch.zeros(5, 2, device=dev), idx, D["sp"][:len(rows)],
        average=avg))

# objects and parameters
res["allgather_object"] = hvt.allgather_object({"rank": r, "pad": "x" * r})
res["broadcast_object"] = hvt.broadcast_object(
    {"root": r, "arr": [1, 2, r]} if r == 1 else None, root_rank=1)
res["broadcast_object_fn"] = hvt.broadcast_object_fn(root_rank=n - 1)(
    "from %d" % r)
torch.manual_seed(r)
small = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2)).to(dev)
hvt.broadcast_parameters(small.state_dict(), root_rank=0)
res["broadcast_parameters"] = enc([p for _, p in sorted(
    small.state_dict().items())])
opt = torch.optim.AdamW(small.parameters(), lr=0.01 * (r + 1))
small(D["x"]).sum().mul(r + 1).backward()
opt.step()
hvt.broadcast_optimizer_state(opt, root_rank=0)
sd = opt.state_dict()
res["broadcast_optimizer_state"] = {
    "lr": sd["param_groups"][0]["lr"],
    "state": enc([sd["state"][i][k] for i in sorted(sd["state"])
                  for k in ("step", "exp_avg", "exp_avg_sq")])}
hvt.broadcast_parameters(small.named_parameters(), root_rank=1)
res["broadcast_named"] = enc([p.detach() for _, p in small.named_parameters()])

# DistributedOptimizer options across ranks
w = torch.nn.Parameter(torch.zeros_like(x))
o = hvt.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                             gradient_predivide_factor=2.0,
                             process_set=ps[0])
w.grad = x.clone()
if ps[0].included():
    o.synchronize()
    res["set0_predivide"] = enc(w.grad)
else:
    res["set0_optimizer_nonmember"] = error_of(o.step)
a = torch.nn.Parameter(torch.zeros_like(ada))
b = torch.nn.Parameter(torch.zeros_like(D["ada2"]))
o = hvt.DistributedOptimizer(torch.optim.SGD([a, b], lr=1.0), op=hvt.Adasum)
a.grad, b.grad = ada.clone(), D["ada2"].clone()
o.synchronize()
res["adasum_optimizer"] = enc([a.grad, b.grad])

cfg = GPTConfig(**G.ENTRY, dtype=torch.float32)
model = GPT(cfg, device=dev, seed=0)
opt = hvt.PartialDistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.1), model.named_parameters(),
    local_layers=G.LOCAL_LAYERS)
tokens = seeded_tokens(cfg, 1, G.ACC_SEQ, seed=3)
make_train_step(model, opt)(tokens)
torch.save({k: v.cpu() for k, v in model.state_dict().items()},
           f"{out}.partial.{r}.pt")

# gradient accumulation: two passes of one row per update
model = GPT(cfg, device=dev, seed=0)
opt = hvt.DistributedOptimizer(
    torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4),
    backward_passes_per_step=2, average_aggregated_gradients=True)
step = make_train_step(model, opt)
tokens = seeded_tokens(cfg, G.ACC_ROWS, G.ACC_SEQ, seed=0)
res["acc_losses"] = [[float(step(tokens[i:i + 1])) for i in range(2)]
                     for _ in range(G.ACC_UPDATES)]
if r == 0:
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               out + ".acc.pt")
res["rank"], res["size"] = r, n
res["topology"] = [hvt.local_rank(), hvt.local_size(), hvt.cross_rank(),
                   hvt.cross_size()]
with open(f"{out}.{r}.json", "w") as f:
    json.dump(res, f)
hvt.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(n, local_size, device, out, timeout=240):
    """Run WORKER on ``n`` processes; return the per-rank results."""
    port = _free_port()
    # the cards this job may use, as the parent process was given them
    cards = os.environ.get("CUDA_VISIBLE_DEVICES",
                           ",".join(map(str, range(n)))).split(",")
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=REPO, HVT_PROCESS_ID=str(r),
                   HVT_NUM_PROCESSES=str(n),
                   HVT_LOCAL_PROCESS_ID=str(r % local_size),
                   HVT_LOCAL_SIZE=str(local_size),
                   HVT_CROSS_RANK=str(r // local_size),
                   HVT_CROSS_SIZE=str(n // local_size),
                   HVT_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   OMP_NUM_THREADS="1")
        if device == "cuda":   # each fake host sees its own cards only
            host = r // local_size
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                cards[host * local_size:(host + 1) * local_size])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, json.dumps([device, out])],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    results = []
    for r in range(n):
        with open(f"{out}.{r}.json") as f:
            results.append(json.load(f))
    return results


def decode(v):
    """A worker's encoded tensor (or list of them) as numpy."""
    if isinstance(v, list):
        return [decode(a) for a in v]
    return np.asarray(v["data"])


# held exactly: integers, bf16 cases of small integers, and data movement
EXACT = {"allgather", "allgather_ragged", "allgather_int", "allgather_bf16",
         "alltoall", "alltoall_splits", "allreduce_bf16", "set1_broadcast",
         "async_allgather", "async_broadcast", "async_alltoall",
         "hier_allgather"}
RTOL, ATOL = 1e-5, 1e-6


def mismatches(results, n, local_size, keys=None):
    """Where the gang's results differ from :func:`expected`: fp32 at rtol
    1e-5 / atol 1e-6, the EXACT keys exactly. Returns a list of messages."""
    want_all = expected(n, local_size)
    bad = []
    for key in keys or want_all:
        for r, want in enumerate(want_all[key]):
            got = results[r].get(key)
            if want is None or got is None:
                if (want is None) != (got is None):
                    bad.append(f"{key} rank {r}: got {got}, want {want}")
                continue
            if key in ("alltoall_recv_splits", "timeout"):
                if got != want:
                    bad.append(f"{key} rank {r}: {got} != {want}")
                continue
            got = decode(got)
            pairs = zip(got, want) if isinstance(want, list) \
                else [(got, want)]
            tol = (0, 0) if key in EXACT else (RTOL, ATOL)
            for g, w in pairs:
                if np.shape(g) != np.shape(w) or not np.allclose(
                        g, w, rtol=tol[0], atol=tol[1]):
                    bad.append(f"{key} rank {r}: {g} != {w}")
    return bad
