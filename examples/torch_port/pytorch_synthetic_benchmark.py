"""A synthetic training benchmark on the port (the JAX package's
``examples/torch/pytorch_synthetic_benchmark.py``; Horovod's
``examples/pytorch/pytorch_synthetic_benchmark.py``):

    python -m horovod_tpu_torch.runner.launch -np 2 \\
        python examples/torch_port/pytorch_synthetic_benchmark.py

Runs on the card of each process's local rank; ``--device cpu`` runs on
gloo.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn as nn
import torch.optim as optim

import horovod_tpu_torch as hvt


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()

    hvt.init(device=args.device)
    dev = hvt.device()
    torch.manual_seed(0)
    model = nn.Sequential(
        nn.Conv2d(3, 32, 3, stride=2), nn.ReLU(),
        nn.Conv2d(32, 64, 3, stride=2), nn.ReLU(),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(64, 10)).to(dev)
    optimizer = optim.SGD(model.parameters(), lr=0.01)
    optimizer = hvt.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())
    hvt.broadcast_parameters(model.state_dict(), root_rank=0)

    data = torch.randn(args.batch_size, 3, 64, 64, device=dev)
    target = torch.randint(0, 10, (args.batch_size,), device=dev)
    loss_fn = nn.CrossEntropyLoss()

    def benchmark_step():
        optimizer.zero_grad()
        loss = loss_fn(model(data), target)
        loss.backward()
        optimizer.step()
        return loss

    benchmark_step()    # warm up
    img_secs = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = benchmark_step()
        loss.item()     # waits for the device
        dt = time.perf_counter() - t0
        img_secs.append(args.batch_size * args.num_batches_per_iter / dt)
    if hvt.rank() == 0:
        print(f"Img/sec per proc: {np.mean(img_secs):.1f} "
              f"+- {1.96 * np.std(img_secs):.1f}")
        print(f"Total img/sec on {hvt.size()} proc(s): "
              f"{hvt.size() * np.mean(img_secs):.1f}")
    hvt.shutdown()


if __name__ == "__main__":
    main()
