"""Batch normalization with storage-dtype traffic and fp32 statistics, ported
from ``horovod_tpu/models/normalization.py`` (``TpuBatchNorm``).

Over ``[N, C, ...]`` activations (the port's NCHW layout; the JAX module is
channels-last), per channel:

- the two moments E[x] and E[x²] are taken in fp32 straight from the
  storage-dtype activations (on the card a bf16 reduction accumulates in
  fp32 without an fp32 copy of its input), and var = E[x²] − E[x]²,
  clamped at 0 (flax's fast variance);
- with a ``process_set`` the two moments are averaged over it, in one
  allreduce, which is the JAX module's ``axis_name`` pmean; the allreduce is
  differentiable, so the gradients are those of the global statistics;
- running statistics are fp32 with flax's momentum convention
  (``ra = m·ra + (1 − m)·batch``, m = 0.9 by default) and the biased
  variance;
- mean, var, scale and bias fold into one fp32 per-channel multiply-add,
  applied in the output dtype (``dtype``, default the input's) in one
  elementwise pass.

Parameters keep flax's names in the port's ``nn.Module`` form: ``weight``
(flax ``scale``), ``bias``, and buffers ``running_mean`` / ``running_var``
(flax ``batch_stats`` ``mean`` / ``var``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from horovod_tpu_torch.ops import collective_ops as C


class TpuBatchNorm(nn.Module):
    """``TpuBatchNorm`` over dim 1. ``train()`` mode uses and updates the
    batch statistics, ``eval()`` mode the running ones. ``scale_init`` is
    the initial scale (0 for the zero-init last norm of a residual
    branch)."""

    def __init__(self, num_features, *, momentum=0.9, eps=1e-5, dtype=None,
                 scale_init=1.0, process_set=None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.process_set = process_set
        self.weight = nn.Parameter(torch.full((num_features,),
                                              float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _moments(self, x):
        dims = [0, *range(2, x.dim())]
        n = x.numel() // x.shape[1]
        acc = torch.promote_types(x.dtype, torch.float32)
        mean = torch.mean(x, dims, dtype=acc)
        mean2 = torch.linalg.vector_norm(x, 2, dims, dtype=acc).square() / n
        if self.process_set is not None and self.process_set.size() > 1:
            mean, mean2 = C.allreduce(torch.cat([mean, mean2]),
                                      op=C.Average,
                                      process_set=self.process_set).chunk(2)
        return mean, (mean2 - mean.square()).clamp_min(0.0)

    def forward(self, x):
        if self.training:
            mean, var = self._moments(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.to(var.dtype)
        shift = self.bias.to(var.dtype) - mean * mul
        dtype = self.dtype or x.dtype
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return torch.addcmul(shift.to(dtype).view(shape), x.to(dtype),
                             mul.to(dtype).view(shape))
