"""Long-context training on the port with ring attention and the sm90
flash kernels (the JAX package's ``examples/jax/jax_long_context_train.py``).

Each process owns one sequence shard of Q/K/V; the K/V shards travel once
around the ring (``parallel/sequence.py``), and each block runs the flash
kernels on the resident shard and merges by its log-sum-exp, so no rank
ever holds the full [seq × seq] scores. One process a shard:

    python -m horovod_tpu_torch.runner.launch -np 4 \\
        python examples/torch_port/long_context_train.py --seq 2048

Runs on the card of each process's local rank in bf16 (the sm90 kernels
take head_dim 64 or 128); ``--device cpu`` runs on gloo in fp32 through
the kernels' plain versions. ``--kv-heads`` makes it grouped-query
attention: the kernels read the shared K/V heads directly. ``--report
PATH`` writes rank 0's losses and kernel launch counts as JSON;
``--attention-report PATH`` writes (``torch.save``) rank 0's attention
output on the first batch, before training, and the gradients of its Q, K
and V under a fixed random cotangent, so that two runs (flash and
``--no-flash``) can be held against each other directly.
"""

import argparse
import json

import numpy as np
import torch

import horovod_tpu_torch as hvt
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
from horovod_tpu_torch.parallel.sequence import ring_attention


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seq", type=int, default=2048,
                   help="global sequence length")
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query attention: K/V head count "
                        "(default = --heads, i.e. MHA; must divide it)")
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--no-flash", action="store_true",
                   help="einsum block step instead of the flash kernels")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--report", default=None)
    p.add_argument("--attention-report", default=None)
    args = p.parse_args()
    if args.steps < 1:
        p.error("--steps must be >= 1")
    kv = args.heads if args.kv_heads is None else args.kv_heads
    if kv < 1 or args.heads % kv:
        p.error(f"--kv-heads ({kv}) must be >= 1 and divide --heads "
                f"({args.heads})")

    hvt.init(device=args.device)
    sp, r, dev = hvt.size(), hvt.rank(), hvt.device()
    if args.seq % sp:
        p.error(f"--seq ({args.seq}) must be divisible by the world size "
                f"({sp}): each process owns one sequence shard")
    mesh = make_parallel_mesh(sp=sp)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    b, s, h, d = args.batch, args.seq, args.heads, args.head_dim
    dm, shard = h * d, args.seq // sp
    rng = np.random.RandomState(0)
    x = rng.randn(b, s, dm) * 0.3
    target = rng.randn(b, s, dm) * 0.3
    mine = slice(r * shard, (r + 1) * shard)
    x = torch.from_numpy(x[:, mine]).to(dev, dtype)
    target = torch.from_numpy(target[:, mine]).to(dev, dtype)
    params = {
        "wq": rng.randn(dm, dm) / np.sqrt(dm),
        "wk": rng.randn(dm, kv * d) / np.sqrt(dm),
        "wv": rng.randn(dm, kv * d) / np.sqrt(dm),
        "wo": rng.randn(dm, dm) / np.sqrt(dm)}
    params = {k: torch.tensor(v, dtype=torch.float32, device=dev,
                              requires_grad=True)
              for k, v in params.items()}
    # each rank's loss is the mean over its shard: the average of the
    # ranks' gradients is the gradient of the mean over the sequence
    opt = hvt.DistributedOptimizer(
        torch.optim.Adam(params.values(), lr=3e-3),
        named_parameters=list(params.items()))

    def proj(w, nh):
        return (x @ w.to(dtype)).reshape(b, shard, nh, d)

    def attention(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, causal=True,
                              use_flash=not args.no_flash)

    def loss_fn():
        o = attention(proj(params["wq"], h), proj(params["wk"], kv),
                      proj(params["wv"], kv))
        out = (o.reshape(b, shard, dm) @ params["wo"].to(dtype)).float()
        return ((out - target.float()) ** 2).mean()

    if args.attention_report:
        with torch.no_grad():
            q, k, v = (proj(params[w], nh).detach().requires_grad_()
                       for w, nh in (("wq", h), ("wk", kv), ("wv", kv)))
        o = attention(q, k, v)
        cot = torch.from_numpy(np.random.RandomState(1 + r).randn(
            *o.shape)).to(dev, torch.float32)
        (o.float() * cot).sum().backward()
        if r == 0:
            torch.save({name: t.detach().float().cpu() for name, t in
                        (("o", o), ("dq", q.grad), ("dk", k.grad),
                         ("dv", v.grad))}, args.attention_report)

    _kernels.reset_launches()
    losses = []
    for i in range(args.steps):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
        losses.append(float(hvt.allreduce(loss.detach(), name="loss")))
        if r == 0 and (i == 0 or (i + 1) % 5 == 0):
            print(f"step {i + 1}: loss {losses[-1]:.5f}", flush=True)
    assert np.isfinite(losses[-1]), "training diverged"
    if r == 0:
        print(f"final loss {losses[-1]:.5f} (seq={s} over {sp}-way ring, "
              f"flash={'off' if args.no_flash else 'on'}, "
              f"heads={h}/{kv} kv)", flush=True)
        if args.report:
            with open(args.report, "w") as f:
                json.dump({"losses": losses,
                           "launches": dict(_kernels.LAUNCHES)}, f)
    hvt.shutdown()


if __name__ == "__main__":
    main()
