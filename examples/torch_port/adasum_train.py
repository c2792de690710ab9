"""Adasum training on the port (the JAX package's
``examples/jax/jax_adasum_train.py``; Horovod's
``examples/adasum/adasum_small_model.py``). Adasum combines the ranks'
gradients scale-invariantly, which keeps large worlds from inflating the
effective learning rate as plain averaging does. Any power-of-two number
of processes:

    python -m horovod_tpu_torch.runner.launch -np 4 \\
        python examples/torch_port/adasum_train.py

Runs on the card of each process's local rank; ``--device cpu`` runs on
gloo.
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvt


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()

    hvt.init(device=args.device)
    n, r, dev = hvt.size(), hvt.rank(), hvt.device()
    if n & (n - 1):
        raise SystemExit(f"Adasum needs a power-of-two world, got {n}")
    rs = np.random.RandomState(0)
    w_true = rs.randn(32, 4).astype(np.float32)
    X = rs.randn(n * 64, 32).astype(np.float32)
    x = torch.from_numpy(X[r * 64:(r + 1) * 64]).to(dev)   # this rank's
    y = x @ torch.from_numpy(w_true).to(dev)
    w = torch.zeros(32, 4, device=dev, requires_grad=True)
    opt = hvt.DistributedOptimizer(torch.optim.SGD([w], lr=0.2),
                                   named_parameters=[("w", w)],
                                   op=hvt.Adasum)
    for i in range(args.steps):
        opt.zero_grad()
        loss = ((x @ w - y) ** 2).mean()
        loss.backward()
        opt.step()      # the gradients, combined by Adasum
        loss = loss.item()
        if r == 0 and (i % 50 == 0 or i == args.steps - 1):
            print(f"step {i:4d}  loss {loss:.6f}", flush=True)
    assert loss < 1e-4, loss
    hvt.shutdown()


if __name__ == "__main__":
    main()
