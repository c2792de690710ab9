"""ImageNet-style ResNet-50 training on the port with fp16 gradient
compression and grouped (fused) allreduce (the JAX package's
``examples/torch/pytorch_imagenet_resnet50.py``; Horovod's
``examples/pytorch/pytorch_imagenet_resnet50.py``):

    python -m horovod_tpu_torch.runner.launch -np 2 \
        python examples/torch_port/pytorch_imagenet_resnet50.py \
        --batch-size 32 --batches-per-allreduce 2

Runs on the card of each process's local rank; ``--device cpu`` runs on
gloo. Horovod's features carried over:
- ``compression=hvd.Compression.fp16`` (reference ``--fp16-allreduce``)
- ``num_groups`` grouped fusion (reference's tensor-fusion knob surfaced
  as an explicit group count)
- ``backward_passes_per_step`` local gradient aggregation
  (``--batches-per-allreduce``)
- linear-scaling LR with gradual warmup over the first 5 epochs
- ``broadcast_parameters`` + ``broadcast_optimizer_state`` from rank 0

Differences, by design: synthetic ImageNet-shaped data (plug a
``DataLoader`` over ImageFolder on a real cluster), and a compact
bottleneck ResNet-50 written here (same stage layout [3, 4, 6, 3], same
parameter scale) rather than torchvision's.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.optim as optim

import horovod_tpu_torch as hvd


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.proj = None
        if stride != 1 or cin != cout:
            self.proj = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        r = x if self.proj is None else self.proj(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + r)


def resnet50(num_classes=1000, width=64):
    """torchvision-equivalent stage layout; ``width`` shrinks the model
    for smoke tests."""
    stages, cin = [], width

    def stage(n_blocks, w, stride):
        nonlocal cin
        blocks = []
        for i in range(n_blocks):
            blocks.append(Bottleneck(cin, w, stride if i == 0 else 1))
            cin = w * Bottleneck.expansion
        return nn.Sequential(*blocks)

    stem = nn.Sequential(
        nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False),
        nn.BatchNorm2d(width), nn.ReLU(),
        nn.MaxPool2d(3, stride=2, padding=1))
    for n, w, s in [(3, width, 1), (4, width * 2, 2), (6, width * 4, 2),
                    (3, width * 8, 2)]:
        stages.append(stage(n, w, s))
    return nn.Sequential(stem, *stages, nn.AdaptiveAvgPool2d(1),
                         nn.Flatten(), nn.Linear(cin, num_classes))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps-per-epoch", type=int, default=4)
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--warmup-epochs", type=float, default=5)
    p.add_argument("--batches-per-allreduce", type=int, default=1,
                   help="local gradient aggregation before the exchange "
                        "(reference --batches-per-allreduce)")
    p.add_argument("--no-fp16-allreduce", action="store_true",
                   help="disable fp16 gradient compression (reference "
                        "--fp16-allreduce, inverted: on by default here "
                        "to exercise the headline config)")
    p.add_argument("--num-groups", type=int, default=2,
                   help="gradient fusion groups (reference tensor-fusion)")
    p.add_argument("--width", type=int, default=64,
                   help="channel width; 8 gives a smoke-test-sized model")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()
    torch.manual_seed(0)

    model = resnet50(width=args.width).to(dev)
    # Linear LR scaling by total batch count (reference: lr * size *
    # batches_per_allreduce), warmed up below.
    scaled_lr = (args.base_lr * hvd.size() * args.batches_per_allreduce)
    optimizer = optim.SGD(model.parameters(), lr=scaled_lr,
                          momentum=0.9, weight_decay=5e-5)

    compression = (hvd.Compression.none if args.no_fp16_allreduce
                   else hvd.Compression.fp16)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression,
        backward_passes_per_step=args.batches_per_allreduce,
        num_groups=args.num_groups)

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    # synthetic ImageNet-shaped batch, one per rank
    rng = np.random.RandomState(hvd.rank())
    data = torch.from_numpy(
        rng.randn(args.batch_size, 3, args.image_size,
                  args.image_size).astype(np.float32)).to(dev)
    target = torch.from_numpy(rng.randint(0, 1000, args.batch_size)).to(dev)

    def warmup_lr(epoch_frac):
        # gradual warmup (Goyal et al.): ramp from base_lr to scaled_lr
        if epoch_frac >= args.warmup_epochs:
            return scaled_lr
        ramp = epoch_frac / args.warmup_epochs
        return args.base_lr * hvd.size() * args.batches_per_allreduce \
            * ramp + args.base_lr * (1 - ramp)

    model.train()
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        for step in range(args.steps_per_epoch):
            lr = warmup_lr(epoch + step / args.steps_per_epoch)
            for g in optimizer.param_groups:
                g["lr"] = lr
            optimizer.zero_grad()
            # accumulate locally; the exchange fires on the Nth backward
            for _ in range(args.batches_per_allreduce):
                loss = F.cross_entropy(model(data), target)
                loss.backward()
            optimizer.step()
        loss.item()     # waits for the device
        dt = time.perf_counter() - t0
        imgs = (args.batch_size * args.batches_per_allreduce
                * args.steps_per_epoch * hvd.size())
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {loss.item():.3f} "
                  f"lr {lr:.4f} {imgs / dt:.1f} img/sec total")
    hvd.shutdown()


if __name__ == "__main__":
    main()
