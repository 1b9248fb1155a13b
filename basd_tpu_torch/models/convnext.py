"""ConvNeXtV2 (FCMAE) feature extractor, the cross-architecture teacher
(counterpart of ``basd_tpu/models/convnext.py``).

Keeps timm's module names (``stem.{0,1}``, ``stages.{i}.downsample.{0,1}``,
``stages.{i}.blocks.{j}.{conv_dw,norm,mlp.fc1,mlp.grn,mlp.fc2}``), so a
timm state dict loads with ``load_state_dict``. Input and output are NHWC,
the JAX package's layout: each conv sees an NCHW view of a channels-last
tensor and hands one back, so the LayerNorms, the MLP and GRN run on
contiguous NHWC rows. Parameters are f32 and cast to the compute
``dtype`` at use, as flax's ``dtype=`` does. Numerics follow the reference:
LayerNorm statistics and GRN's sum of squares in f32, tanh-GELU at bf16 and
erf at f32 (``convnext.py:38-43``, ``:60-62``). The convs and norms are
PyTorch's own (cuDNN and ``F.layer_norm`` on the card); the JAX package runs
them in XLA, not in a Pallas kernel. An f32 model's convs run without TF32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ConvNeXtConfig:
    depths: tuple[int, ...] = (3, 3, 9, 3)
    dims: tuple[int, ...] = (96, 192, 384, 768)
    name: str = "convnextv2_tiny"

    @property
    def embed_dim(self) -> int:
        return self.dims[-1]


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype):
    """``conv`` on NHWC ``x`` in ``dtype``, NHWC out. At f32 on CUDA, cuDNN
    runs without TF32 whatever the process-wide setting."""
    x = x.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w = conv.weight.to(dtype).contiguous(memory_format=torch.channels_last)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if x.is_cuda and dtype == torch.float32:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            y = conv._conv_forward(x, w, b)
    else:
        y = conv._conv_forward(x, w, b)
    return y.permute(0, 2, 3, 1)


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the last (channel) axis with f32 statistics and
    affine, output in the compute ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXtV2) on NHWC input: the
    per-channel L2 norm over H, W in f32, normalised by its channel mean."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.bias = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        gx = torch.sqrt((x.float() ** 2).sum(dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        y = self.weight * (x * nx.to(x.dtype)).float() + self.bias + x.float()
        return y.to(x.dtype)


class ConvNeXtMlp(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        x = F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        x = F.gelu(x, approximate="tanh" if dt == torch.bfloat16 else "none")
        x = self.grn(x)
        return F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = ChannelLayerNorm(dim, dtype)
        self.mlp = ConvNeXtMlp(dim, dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        y = conv_nhwc(self.conv_dw, x, self.compute_dtype)
        return x + self.mlp(self.norm(y))


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.downsample = (nn.Sequential(ChannelLayerNorm(in_dim, dtype),
                                         nn.Conv2d(in_dim, dim, 2, stride=2))
                           if downsample else None)
        self.blocks = nn.Sequential(*(ConvNeXtBlock(dim, dtype)
                                      for _ in range(depth)))
        self.compute_dtype = dtype

    def forward(self, x):
        if self.downsample is not None:
            x = conv_nhwc(self.downsample[1], self.downsample[0](x),
                          self.compute_dtype)
        return self.blocks(x)


class ConvNeXtV2(nn.Module):
    """NHWC images (B, S, S, 3) -> ``{'features': (B, S/32, S/32, C)}``,
    the final stage's map (timm's ``forward_features``)."""

    def __init__(self, cfg: ConvNeXtConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.stem = nn.Sequential(nn.Conv2d(3, cfg.dims[0], 4, stride=4),
                                  ChannelLayerNorm(cfg.dims[0], dtype))
        self.stages = nn.ModuleList(
            ConvNeXtStage(cfg.dims[max(i - 1, 0)], dim, depth, i > 0, dtype)
            for i, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims))
        )

    def forward(self, x, *, deterministic: bool = True):
        x = self.stem[1](conv_nhwc(self.stem[0], x, self.compute_dtype))
        for stage in self.stages:
            x = stage(x)
        return {"features": x}
