"""VGG-16 (with batch norm) and Inception V3 (no aux head), ported from
``horovod_tpu/models/vision.py``: the other two models of the repo's image
benchmark (``bench.py --model vgg16|inception_v3``).

NCHW activations in ``dtype`` with fp32 parameters; every conv is followed
by batch norm (epsilon 1e-3, ``norm_impl`` as in ``models/resnet.py``) and
ReLU; pooling follows flax (VALID max pools, "SAME" average pools that
count the padding). Submodules carry the flax module names (``conv2_1``,
``mixed6b/t1_c2``, ``red7a_b4``, ``pool_proj``, ``fc1``, ``head``). VGG's
classifier flattens the features in flax's (H, W, C) order, so ``fc1``
takes flax's weights transposed and nothing more; its width follows
``image_size``.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.layers import Conv, Dense, norm_layer

IN_CHANNELS = 3
BN_EPS = 1e-3


class ConvBN(nn.Module):
    """conv → batch norm → ReLU (``_ConvBN``)."""

    def __init__(self, cin, cout, kernel=(3, 3), stride=(1, 1),
                 padding="SAME", *, dtype, norm_impl, process_set, generator):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, padding, dtype=dtype,
                           generator=generator)
        self.prefix, norm = norm_layer(norm_impl, cout, eps=BN_EPS,
                                       dtype=dtype, process_set=process_set)
        self.add_module(f"{self.prefix}_0", norm)

    def forward(self, x):
        return F.relu(getattr(self, f"{self.prefix}_0")(self.Conv_0(x)))


def _factories(dtype, norm_impl, process_set, seed):
    """The seeded generator of one model's weights and its ConvBN
    factory."""
    gen = torch.Generator().manual_seed(seed)
    return gen, partial(ConvBN, dtype=dtype, norm_impl=norm_impl,
                        process_set=process_set, generator=gen)


class VGG16(nn.Module):
    """VGG-16 (configuration D) with batch norm; fp32 logits."""

    BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 norm_impl="tpu", process_set=None, *, image_size=224,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen, cbn = _factories(dtype, norm_impl, process_set, seed)
        self.dtype = dtype
        cin, size = IN_CHANNELS, image_size
        self.convs = []
        for block, (features, convs) in enumerate(self.BLOCKS):
            for i in range(convs):
                name = f"conv{block}_{i}"
                self.add_module(name, cbn(cin, features))
                self.convs.append((name, i == convs - 1))
                cin = features
            size //= 2
        dense = partial(Dense, dtype=dtype, generator=gen)
        self.fc1 = dense(size * size * cin, 4096)
        self.fc2 = dense(4096, 4096)
        self.head = Dense(4096, num_classes, generator=gen)
        self.to(device)

    def forward(self, x):
        x = x.to(self.dtype)
        for name, pool in self.convs:
            x = getattr(self, name)(x)
            if pool:
                x = F.max_pool2d(x, 2, stride=2)
        x = x.permute(0, 2, 3, 1).flatten(1)       # flax's (H, W, C) order
        x = F.relu(self.fc1(x))
        return self.head(F.relu(self.fc2(x)))


class InceptionTower(nn.Module):
    """One mixed block (``_InceptionTower``): parallel ConvBN towers, and a
    "SAME" 3×3 average pool with a 1×1 projection, concatenated on
    channels. ``towers`` lists each tower's (features, kernel) convs."""

    def __init__(self, cin, towers, pool_features, cbn):
        super().__init__()
        self.towers = []
        for t, tower in enumerate(towers):
            names, c = [], cin
            for i, (features, kernel) in enumerate(tower):
                self.add_module(f"t{t}_c{i}", cbn(c, features, kernel))
                names.append(f"t{t}_c{i}")
                c = features
            self.towers.append(names)
        self.pool_proj = cbn(cin, pool_features, (1, 1))
        self.out_channels = (sum(tower[-1][0] for tower in towers)
                             + pool_features)

    def forward(self, x):
        outs = []
        for names in self.towers:
            h = x
            for name in names:
                h = getattr(self, name)(h)
            outs.append(h)
        p = F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)
        outs.append(self.pool_proj(p))
        return torch.cat(outs, dim=1)


class InceptionV3(nn.Module):
    """Inception V3 for 299×299 images, aux head omitted; fp32 logits."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 norm_impl="tpu", process_set=None, *, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen, cbn = _factories(dtype, norm_impl, process_set, seed)
        self.dtype = dtype
        s2 = dict(stride=(2, 2), padding="VALID")
        self.stem1 = cbn(IN_CHANNELS, 32, **s2)
        self.stem2 = cbn(32, 32, padding="VALID")
        self.stem3 = cbn(32, 64)
        self.stem4 = cbn(64, 80, (1, 1), padding="VALID")
        self.stem5 = cbn(80, 192, padding="VALID")
        cin, self.mixed5 = 192, []
        for i, pf in enumerate((32, 64, 64)):
            name = f"mixed5{'bcd'[i]}"
            self.add_module(name, InceptionTower(cin, [
                [(64, (1, 1))],
                [(48, (1, 1)), (64, (5, 5))],
                [(64, (1, 1)), (96, (3, 3)), (96, (3, 3))]], pf, cbn))
            cin = getattr(self, name).out_channels
            self.mixed5.append(name)
        self.red6a_a = cbn(cin, 384, **s2)
        self.red6a_b1 = cbn(cin, 64, (1, 1))
        self.red6a_b2 = cbn(64, 96)
        self.red6a_b3 = cbn(96, 96, **s2)
        cin, self.mixed6 = 384 + 96 + cin, []
        for i, f7 in enumerate((128, 160, 160, 192)):
            name = f"mixed6{'bcde'[i]}"
            self.add_module(name, InceptionTower(cin, [
                [(192, (1, 1))],
                [(f7, (1, 1)), (f7, (1, 7)), (192, (7, 1))],
                [(f7, (1, 1)), (f7, (7, 1)), (f7, (1, 7)), (f7, (7, 1)),
                 (192, (1, 7))]], 192, cbn))
            cin = getattr(self, name).out_channels
            self.mixed6.append(name)
        self.red7a_a1 = cbn(cin, 192, (1, 1))
        self.red7a_a2 = cbn(192, 320, **s2)
        self.red7a_b1 = cbn(cin, 192, (1, 1))
        self.red7a_b2 = cbn(192, 192, (7, 1))
        self.red7a_b3 = cbn(192, 192, (1, 7))
        self.red7a_b4 = cbn(192, 192, **s2)
        cin = 320 + 192 + cin
        for m in "bc":
            self.add_module(f"m7{m}_b0", cbn(cin, 320, (1, 1)))
            self.add_module(f"m7{m}_b1", cbn(cin, 384, (1, 1)))
            self.add_module(f"m7{m}_b1a", cbn(384, 384, (1, 3)))
            self.add_module(f"m7{m}_b1b", cbn(384, 384, (3, 1)))
            self.add_module(f"m7{m}_b2", cbn(cin, 448, (1, 1)))
            self.add_module(f"m7{m}_b2a", cbn(448, 384))
            self.add_module(f"m7{m}_b2b", cbn(384, 384, (1, 3)))
            self.add_module(f"m7{m}_b2c", cbn(384, 384, (3, 1)))
            self.add_module(f"m7{m}_pool", cbn(cin, 192, (1, 1)))
            cin = 320 + 768 + 768 + 192
        self.head = Dense(cin, num_classes, generator=gen)
        self.to(device)

    def forward(self, x):
        x = x.to(self.dtype)
        x = self.stem3(self.stem2(self.stem1(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = F.max_pool2d(self.stem5(self.stem4(x)), 3, stride=2)
        for name in self.mixed5:
            x = getattr(self, name)(x)
        x = torch.cat([
            self.red6a_a(x),
            self.red6a_b3(self.red6a_b2(self.red6a_b1(x))),
            F.max_pool2d(x, 3, stride=2)], dim=1)
        for name in self.mixed6:
            x = getattr(self, name)(x)
        x = torch.cat([
            self.red7a_a2(self.red7a_a1(x)),
            self.red7a_b4(self.red7a_b3(self.red7a_b2(self.red7a_b1(x)))),
            F.max_pool2d(x, 3, stride=2)], dim=1)
        for m in "bc":
            def layer(name, h, m=m):
                return getattr(self, f"m7{m}_{name}")(h)

            y1 = layer("b1", x)
            y1 = torch.cat([layer("b1a", y1), layer("b1b", y1)], dim=1)
            y2 = layer("b2a", layer("b2", x))
            y2 = torch.cat([layer("b2b", y2), layer("b2c", y2)], dim=1)
            p = F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)
            x = torch.cat([layer("b0", x), y1, y2, layer("pool", p)], dim=1)
        return self.head(x.mean(dim=(2, 3)))
