"""Elastic training on the port (the JAX package's
``examples/elastic/pytorch_elastic_train.py``; Horovod's
``examples/elastic/pytorch/pytorch_mnist_elastic.py``):

    python -m horovod_tpu_torch.runner.launch --min-np 2 --max-np 4 -np 2 \
        --host-discovery-script ./discover.sh \
        python examples/torch_port/pytorch_elastic_train.py

``TorchState`` snapshots the model, the optimizer and the progress; when a
worker is lost the survivors roll back to the last ``commit()`` and the
job goes on at the smaller (or grown) world size. Runs on the card of each
process's local rank; ``--device cpu`` runs on gloo.
"""

import argparse

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.optim as optim

import horovod_tpu_torch as hvd


def make_model():
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 4))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--batches-per-epoch", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()

    model = make_model().to(dev)
    optimizer = optim.SGD(model.parameters(),
                          lr=args.lr * hvd.size(), momentum=0.9)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())

    # synthetic regression task with a fixed ground truth so the loss
    # decreases monotonically across elastic events
    rs = np.random.RandomState(1234)
    w_true = rs.randn(8, 4).astype(np.float32)

    @hvd.elastic.run
    def train(state):
        while state.epoch < args.epochs:
            # resume mid-epoch after a restart (state.batch > 0)
            for batch in range(state.batch, args.batches_per_epoch):
                rs_b = np.random.RandomState(
                    1000 * state.epoch + batch + hvd.rank())
                x = torch.from_numpy(
                    rs_b.randn(args.batch_size, 8).astype(np.float32)).to(dev)
                y = x @ torch.from_numpy(w_true).to(dev)
                optimizer.zero_grad()
                loss = F.mse_loss(model(x), y)
                loss.backward()
                optimizer.step()
                state.batch = batch + 1
                state.commit()    # snapshot + host-update check
            if hvd.rank() == 0:
                print(f"epoch {state.epoch}: loss {loss.item():.4f} "
                      f"size={hvd.size()}")
            state.epoch += 1
            state.batch = 0
            state.commit()
        return model

    state = hvd.elastic.TorchState(model=model, optimizer=optimizer,
                                   epoch=0, batch=0)
    train(state)
    if hvd.rank() == 0:
        print(f"done: epochs={args.epochs} final size={hvd.size()}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
