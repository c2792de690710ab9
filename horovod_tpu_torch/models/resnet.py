"""ResNet v1.5, ported from ``horovod_tpu/models/resnet.py``: the model of
the repo's image benchmark (``bench.py --model resnet50``).

NCHW activations in ``dtype`` (bf16 by default) with fp32 parameters; the
stride-2 of a downsampling bottleneck sits in its 3×3 conv; the last norm
of each residual branch starts with scale 0, so the branch starts as the
identity; batch norm by ``norm_impl`` (``models/layers.py``): "tpu" is
:class:`TpuBatchNorm`, "flax" is :class:`SyncBatchNorm`. With
``process_set``, TpuBatchNorm's moments are averaged over it (the JAX
model's ``axis_name``).

Submodules carry the flax module names (``conv_init``, ``bn_init``,
``BottleneckBlock_3/Conv_1``, ``.../TpuBatchNorm_2``, ``proj_conv``,
``head``), so ``models/convert.py`` maps weights by name alone.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.layers import Conv, Dense, norm_layer
from horovod_tpu_torch.models.transformer import _lecun_normal_

IN_CHANNELS = 3


class SpaceToDepthStem(nn.Module):
    """The 7×7/2 stem conv as the numerically identical 4×4/1 conv over
    2×2 pixel blocks folded into channels (``_SpaceToDepthStem``): the same
    ``weight`` [width, C, 7, 7], rearranged at each call. Needs an even
    input height and width."""

    def __init__(self, cin, cout, *, dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, 7, 7))
        _lecun_normal_(self.weight, cin * 49, generator)

    def forward(self, x):
        b, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(
                f"the space-to-depth stem folds 2x2 pixel blocks into "
                f"channels and needs an even input height and width; got "
                f"{h}x{w}: pad the input or build the model with "
                f"conv0_space_to_depth=False")
        # pixels [B, C, H, W] -> [B, 4C, H/2, W/2], channel (a, b, c): a the
        # row parity, b the column parity
        x2 = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
        x2 = x2.reshape(b, 4 * c, h // 2, w // 2)
        # weights: one leading zero row and column make tap u = 2·d + a - 1,
        # then each dim splits into (block d, parity a), parity to channels
        k = F.pad(self.weight, (1, 0, 1, 0))
        k = k.reshape(-1, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        k = k.reshape(-1, 4 * c, 4, 4)
        # output i reads folded rows i - 2 .. i + 1: padding (2, 1)
        return F.conv2d(F.pad(x2.to(self.dtype), (2, 1, 2, 1)),
                        k.to(self.dtype))


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (stride here) → 1×1 (×4 channels), with a 1×1 projection
    of the residual when the shape changes."""

    def __init__(self, cin, filters, stride, make_conv, make_norm):
        super().__init__()
        out = filters * 4
        for i, (a, b, k, s) in enumerate(((cin, filters, 1, 1),
                                          (filters, filters, 3, stride),
                                          (filters, out, 1, 1))):
            self.add_module(f"Conv_{i}", make_conv(a, b, (k, k), (s, s)))
            prefix, norm = make_norm(b, scale_init=0.0 if i == 2 else 1.0)
            self.add_module(f"{prefix}_{i}", norm)
        self.norms = [getattr(self, f"{prefix}_{i}") for i in range(3)]
        self.convs = [getattr(self, f"Conv_{i}") for i in range(3)]
        self.project = stride != 1 or cin != out
        if self.project:
            self.proj_conv = make_conv(cin, out, (1, 1), (stride, stride))
            self.proj_norm = make_norm(out)[1]

    def forward(self, x):
        y = x
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y))
            if i < 2:
                y = F.relu(y)
        residual = self.proj_norm(self.proj_conv(x)) if self.project else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 over ``[N, 3, H, W]`` images; returns fp32 logits.
    Weights are drawn from ``seed`` on the CPU, then moved to ``device``
    (CUDA by default; raises when there is none unless another device is
    passed)."""

    def __init__(self, stage_sizes, num_classes=1000, width=64,
                 dtype=torch.bfloat16, norm_impl="tpu",
                 conv0_space_to_depth=False, process_set=None, *,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        make_conv = partial(Conv, dtype=dtype, generator=gen)
        make_norm = partial(norm_layer, norm_impl, eps=1e-5, dtype=dtype,
                            process_set=process_set)
        if conv0_space_to_depth:
            self.conv_init = SpaceToDepthStem(IN_CHANNELS, width, dtype=dtype,
                                              generator=gen)
        else:
            self.conv_init = make_conv(IN_CHANNELS, width, (7, 7), (2, 2),
                                       ((3, 3), (3, 3)))
        self.bn_init = make_norm(width)[1]
        cin, i = width, 0
        for stage, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if stage > 0 and j == 0 else 1
                filters = width * 2 ** stage
                self.add_module(f"BottleneckBlock_{i}", BottleneckBlock(
                    cin, filters, stride, make_conv, make_norm))
                cin, i = filters * 4, i + 1
        self.n_blocks = i
        self.head = Dense(cin, num_classes, generator=gen)
        self.to(device)

    def forward(self, x):
        x = F.relu(self.bn_init(self.conv_init(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x)
        return self.head(x.mean(dim=(2, 3)))


ResNet50 = partial(ResNet, [3, 4, 6, 3])
ResNet101 = partial(ResNet, [3, 4, 23, 3])
ResNet152 = partial(ResNet, [3, 8, 36, 3])
