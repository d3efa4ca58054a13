"""Inception-v4 feature extractor for the latent-MSE metric (counterpart of
`evoworld_tpu/eval/inception_v4.py`).

timm's `inception_v4` with its module names (`features.0.conv.weight`,
`features.4.branch1.2.bn.running_var`, `features.19.branch1_1a.conv.weight`,
...), so a timm state dict loads with `load_state_dict` (its classifier,
`last_linear`, is left out: the metric reads the pooled features). Batch
norms in eval mode, epsilon 1e-3. (N, 299, 299, 3) normalised images,
channels-last as in the JAX package -> (N, 1536) pooled features.
`latent_mse` is the metric's reduction over two feature sets.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBN(nn.Module):
    """Conv (no bias) + eval-mode batch norm + ReLU (timm ConvNormAct)."""

    def __init__(self, cin: int, cout: int, kernel=1, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool() -> nn.Module:
    return nn.AvgPool2d(3, 1, 1, count_include_pad=False)


class Mixed3a(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = ConvBN(64, 96, 3, 2)

    def forward(self, x):
        return torch.cat([F.max_pool2d(x, 3, 2), self.conv(x)], 1)


class Mixed4a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(ConvBN(160, 64), ConvBN(64, 96, 3))
        self.branch1 = nn.Sequential(ConvBN(160, 64), ConvBN(64, 64, (1, 7), padding=(0, 3)),
                                     ConvBN(64, 64, (7, 1), padding=(3, 0)), ConvBN(64, 96, 3))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x)], 1)


class Mixed5a(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = ConvBN(192, 192, 3, 2)

    def forward(self, x):
        return torch.cat([self.conv(x), F.max_pool2d(x, 3, 2)], 1)


class InceptionA(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = ConvBN(384, 96)
        self.branch1 = nn.Sequential(ConvBN(384, 64), ConvBN(64, 96, 3, padding=1))
        self.branch2 = nn.Sequential(ConvBN(384, 64), ConvBN(64, 96, 3, padding=1), ConvBN(96, 96, 3, padding=1))
        self.branch3 = nn.Sequential(_avg_pool(), ConvBN(384, 96))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


class ReductionA(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = ConvBN(384, 384, 3, 2)
        self.branch1 = nn.Sequential(ConvBN(384, 192), ConvBN(192, 224, 3, padding=1), ConvBN(224, 256, 3, 2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), F.max_pool2d(x, 3, 2)], 1)


class InceptionB(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = ConvBN(1024, 384)
        self.branch1 = nn.Sequential(ConvBN(1024, 192), ConvBN(192, 224, (1, 7), padding=(0, 3)),
                                     ConvBN(224, 256, (7, 1), padding=(3, 0)))
        self.branch2 = nn.Sequential(ConvBN(1024, 192), ConvBN(192, 192, (7, 1), padding=(3, 0)),
                                     ConvBN(192, 224, (1, 7), padding=(0, 3)), ConvBN(224, 224, (7, 1), padding=(3, 0)),
                                     ConvBN(224, 256, (1, 7), padding=(0, 3)))
        self.branch3 = nn.Sequential(_avg_pool(), ConvBN(1024, 128))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


class ReductionB(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(ConvBN(1024, 192), ConvBN(192, 192, 3, 2))
        self.branch1 = nn.Sequential(ConvBN(1024, 256), ConvBN(256, 256, (1, 7), padding=(0, 3)),
                                     ConvBN(256, 320, (7, 1), padding=(3, 0)), ConvBN(320, 320, 3, 2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = ConvBN(1536, 256)
        self.branch1_0 = ConvBN(1536, 384)
        self.branch1_1a = ConvBN(384, 256, (1, 3), padding=(0, 1))
        self.branch1_1b = ConvBN(384, 256, (3, 1), padding=(1, 0))
        self.branch2_0 = ConvBN(1536, 384)
        self.branch2_1 = ConvBN(384, 448, (3, 1), padding=(1, 0))
        self.branch2_2 = ConvBN(448, 512, (1, 3), padding=(0, 1))
        self.branch2_3a = ConvBN(512, 256, (1, 3), padding=(0, 1))
        self.branch2_3b = ConvBN(512, 256, (3, 1), padding=(1, 0))
        self.branch3 = nn.Sequential(_avg_pool(), ConvBN(1536, 256))

    def forward(self, x):
        b1 = self.branch1_0(x)
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        return torch.cat([self.branch0(x), self.branch1_1a(b1), self.branch1_1b(b1), self.branch2_3a(b2),
                          self.branch2_3b(b2), self.branch3(x)], 1)


class InceptionV4Features(nn.Module):
    """(N, 299, 299, 3) in [-1, 1] (normalised) -> (N, 1536) pooled features."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            ConvBN(3, 32, 3, 2), ConvBN(32, 32, 3), ConvBN(32, 64, 3, padding=1),
            Mixed3a(), Mixed4a(), Mixed5a(),
            *[InceptionA() for _ in range(4)], ReductionA(),
            *[InceptionB() for _ in range(7)], ReductionB(),
            *[InceptionC() for _ in range(3)],
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x.permute(0, 3, 1, 2)).mean(dim=(2, 3))


def latent_mse(feats_a: torch.Tensor, feats_b: torch.Tensor) -> torch.Tensor:
    """Mean squared distance between feature sets (upstream
    calculate_latent_mse.py:34-45), in fp32 with TF32 off (`full_fp32`)."""
    from evoworld_tpu_torch.eval.metrics import full_fp32

    with full_fp32():
        return torch.mean((feats_a.float() - feats_b.float()) ** 2)
