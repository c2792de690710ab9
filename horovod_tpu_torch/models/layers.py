"""flax's ``nn.Conv`` and ``nn.Dense`` as the vision models of the JAX
package use them (fp32 parameters, products in ``dtype``), in the port's
NCHW layout, and the choice of batch norm behind ``norm_impl``.

Padding follows flax, not PyTorch: "SAME" pads ``total = max((out - 1) ·
stride + k - size, 0)`` split as ``(total // 2, total - total // 2)``, so a
stride-2 3×3 conv on an even input pads (0, 1) where PyTorch's
``padding=1`` pads (1, 1): the same output shape and other numbers. An
uneven split is padded explicitly before the convolution.

Weights are flax's default ``lecun_normal`` (a truncated normal of variance
1 / fan_in) drawn from the caller's generator; biases start at zero. The
layouts are PyTorch's (``weight`` ``[out, in, kh, kw]`` and ``[out, in]``);
``models/convert.py`` transposes flax's HWIO and ``(in, out)`` kernels.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.normalization import TpuBatchNorm
from horovod_tpu_torch.models.transformer import _lecun_normal_
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm

NORM_IMPLS = ("tpu", "flax")


def same_padding(size, kernel, stride):
    """flax's "SAME" (low, high) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad2d(x, pads):
    """Pad ``x`` [N, C, H, W] by ``pads`` ((top, bottom), (left, right)) and
    return it with the symmetric padding left for the convolution."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b)), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``: ``padding`` is "SAME", "VALID" or
    ((top, bottom), (left, right))."""

    def __init__(self, cin, cout, kernel=(3, 3), stride=(1, 1),
                 padding="SAME", *, dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, *self.kernel))
        _lecun_normal_(self.weight, cin * self.kernel[0] * self.kernel[1],
                       generator)

    def pads(self, height, width):
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SAME":
            return tuple(same_padding(n, k, s) for n, k, s in zip(
                (height, width), self.kernel, self.stride))
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x):
        x, padding = _pad2d(x.to(self.dtype), self.pads(*x.shape[-2:]))
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=padding)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` [out, in] and ``bias``, in ``dtype``."""

    def __init__(self, cin, cout, *, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        _lecun_normal_(self.weight, cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def norm_layer(norm_impl, num_features, *, eps, dtype, process_set=None,
               scale_init=1.0):
    """(flax name prefix, module) of the batch norm that ``norm_impl``
    names, at flax momentum 0.9:

    - "tpu": :class:`TpuBatchNorm` in ``dtype``, its moments averaged over
      ``process_set`` when one of more than one process is given;
    - "flax": :class:`SyncBatchNorm` (torch momentum 0.1, fp32 statistics
      and normalization, unbiased running variance), synchronized over all
      processes in training.
    """
    if norm_impl == "tpu":
        return "TpuBatchNorm", TpuBatchNorm(
            num_features, momentum=0.9, eps=eps, dtype=dtype,
            scale_init=scale_init, process_set=process_set)
    if norm_impl == "flax":
        bn = SyncBatchNorm(num_features, eps=eps, momentum=0.1)
        nn.init.constant_(bn.weight, scale_init)
        return "BatchNorm", bn
    raise ValueError(f"norm_impl must be one of {NORM_IMPLS}, got "
                     f"{norm_impl!r}")
