"""ResNet-50 feature extractor, the frozen CNN teacher of CNN-to-ViT BASD
(counterpart of ``basd_tpu/models/resnet.py``; ``BASELINE.json`` config 3).

Keeps torchvision's module names (``conv1``, ``bn1``,
``layer{i}.{b}.{conv1,bn1,...,downsample.{0,1}}``), BatchNorm buffers
included, so a torchvision state dict loads with ``load_state_dict``.
Input and output are NHWC; the convs (PyTorch's, cuDNN on the card) see
NCHW views of channels-last tensors. BatchNorm always uses its running
statistics (the teacher is frozen) and rounds as the reference's
``_FrozenBN`` does (``resnet.py:25-37``): the mean and ``inv * scale`` are
cast to the input dtype before use, each product rounded there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from basd_tpu_torch.models.convnext import conv_nhwc


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    name: str = "resnet50"

    @property
    def embed_dim(self) -> int:
        return self.width * 8 * 4  # 2048 for resnet50


class FrozenBatchNorm(nn.Module):
    """BatchNorm with running statistics only, on NHWC input."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        inv = (self.running_var.float() + 1e-5) ** -0.5
        y = (x - self.running_mean.to(x.dtype)) * (inv * self.weight).to(x.dtype)
        return y + self.bias.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, project: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = FrozenBatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = FrozenBatchNorm(filters)
        self.conv3 = _conv(filters, 4 * filters, 1)
        self.bn3 = FrozenBatchNorm(4 * filters)
        self.downsample = (nn.Sequential(_conv(cin, 4 * filters, 1, stride),
                                         FrozenBatchNorm(4 * filters))
                           if project else None)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.relu(self.bn1(conv_nhwc(self.conv1, x, dt)))
        y = F.relu(self.bn2(conv_nhwc(self.conv2, y, dt)))
        y = self.bn3(conv_nhwc(self.conv3, y, dt))
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample[1](conv_nhwc(self.downsample[0], x, dt))
        return F.relu(shortcut + y)


class ResNet(nn.Module):
    """NHWC images (B, S, S, 3) -> ``{'features': (B, S/32, S/32, 32 w)}``,
    the last stage's map (``forward_features``)."""

    def __init__(self, cfg: ResNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(3, cfg.width, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(cfg.width)
        cin = cfg.width
        for si, num_blocks in enumerate(cfg.stage_sizes):
            filters = cfg.width * 2 ** si
            blocks = []
            for bi in range(num_blocks):
                blocks.append(Bottleneck(cin, filters,
                                         2 if si > 0 and bi == 0 else 1,
                                         bi == 0, dtype))
                cin = 4 * filters
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x, *, deterministic: bool = True):
        x = F.relu(self.bn1(conv_nhwc(self.conv1, x, self.compute_dtype)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
        x = x.permute(0, 2, 3, 1)
        for si in range(len(self.cfg.stage_sizes)):
            x = getattr(self, f"layer{si + 1}")(x)
        return {"features": x}
