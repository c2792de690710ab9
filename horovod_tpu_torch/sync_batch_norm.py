"""Cross-process synchronized batch normalization (the JAX package's torch
binding ``horovod_tpu/torch/sync_batch_norm.py``; its flax counterpart is
``horovod_tpu/jax/sync_batch_norm.py``).

In training, over more than one process, each process's ``[count, sum,
sum of squares]`` per channel goes through one fused allreduce (Sum) of
the differentiable :func:`~horovod_tpu_torch.ops.collective_ops.allreduce`,
so autograd derives the backward of the global statistics. Unlike the
binding, the count stays a tensor (no ``.item()``), so the forward makes no
host sync and a CUDA graph can capture it. In eval mode, or in a world of one
process, it is ``nn.BatchNorm``'s forward with local statistics.
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import collective_ops as C


class SyncBatchNorm(_BatchNorm):
    """BatchNorm over dim 1 whose batch statistics are those of the global
    batch across all processes: torch's momentum convention (0.1 is the
    weight of the new batch) and the unbiased running variance."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)")

    def forward(self, input):
        if (not self.training or not basics.is_initialized()
                or basics.size() == 1):
            return super().forward(input)
        self._check_input_dim(input)
        dims = [0, *range(2, input.dim())]
        c = input.shape[1]
        x = input.float()
        count = torch.full((1,), float(input.numel() // c),
                           device=input.device)
        stats = C.allreduce(torch.cat([count, x.sum(dims),
                                       (x * x).sum(dims)]), op=C.Sum)
        total = stats[0]
        mean = stats[1:1 + c] / total
        var = stats[1 + c:] / total - mean * mean
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked += 1
                m = (1.0 / float(self.num_batches_tracked)
                     if self.momentum is None else self.momentum)
                unbiased = var * total / (total - 1).clamp_min(1)
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
        shape = (1, -1) + (1,) * (input.dim() - 2)
        out = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        if self.affine:
            out = out * self.weight.view(shape) + self.bias.view(shape)
        return out.to(input.dtype)
