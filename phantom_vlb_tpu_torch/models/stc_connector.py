"""STC connector: the spatial-temporal downsampler between CLIP and the LLM, frozen.

Counterpart of ``phantom_vlb_tpu/models/stc_connector.py``: ``STCConfig``
(:39-58), the channel LayerNorm (:59-69), squeeze-excite (:72-87), the
RegNet-Y bottleneck (:90-123), the stage (:126-145) and the connector
(:148-192)::

    (B, T, 24, 24, C_enc) -> s1: RegStage per frame -> C
      -> sampler: Conv3d k 2, stride 2, padding 1 (+ bias) -> SiLU  (12, 24, 24 -> 7, 13, 13)
      -> s2: RegStage per downsampled frame
      -> readout: Linear (-> exact GELU -> Linear) x (mlp_depth - 1)
      -> (B, 7 * 13 * 13, E) tokens in (t, h, w) order

A bottleneck is 1x1 conv -> LN -> SiLU -> depthwise 3x3 (padding 1) -> LN
-> SiLU -> squeeze-excite (its width ``round(in_chs * se_ratio)``, from the
block's input width) -> 1x1 conv -> LN, plus the input (through 1x1 conv ->
LN when the widths differ), then SiLU.

Activations stay channels-last, (N, H, W, C) and (B, T, H, W, C) as in the
reference, so every LayerNorm runs over the contiguous last axis and the
tokens come out in (t, h, w) order. A 1x1 conv there is a product over the
last axis (``F.linear`` on the (out, in) view of its OIHW weight); the
depthwise conv and the sampler take a permuted view, which is an NCHW
(NCDHW) tensor in channels-last memory, and give one back. Weights are
stored as PyTorch convolutions store them (OIHW, OIDHW) in the compute
dtype, the LayerNorms' in f32 (:class:`~phantom_vlb_tpu_torch.models.clip_vit.LayerNorm`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from phantom_vlb_tpu_torch.models.clip_vit import LayerNorm

__all__ = ["STCConfig", "STCConnector", "RegBottleneck", "RegStage", "SqueezeExcite"]


@dataclasses.dataclass(frozen=True)
class STCConfig:
    encoder_hidden_size: int = 1024   # CLIP ViT-L width
    hidden_size: int = 4096           # the connector's width
    output_hidden_size: int = 4096    # the LLM's width
    depth: int = 4
    mlp_depth: int = 2
    se_ratio: float = 0.25
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(**overrides) -> "STCConfig":
        """The reference's tiny connector (64 -> 96 -> 64, depth 1), in f32."""
        base = dict(encoder_hidden_size=64, hidden_size=96, output_hidden_size=64, depth=1,
                    dtype=torch.float32)
        base.update(overrides)
        return STCConfig(**base)


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv on channels-last (..., C_in) activations."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, rd_channels: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, rd_channels, 1, dtype=dtype)
        self.fc2 = nn.Conv2d(rd_channels, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C)."""
        a = F.silu(_conv1x1(x.mean(dim=(1, 2), keepdim=True), self.fc1))
        return x * torch.sigmoid(_conv1x1(a, self.fc2))


class RegBottleneck(nn.Module):
    """RegNet-Y bottleneck at VideoLLaMA2's settings (timm ``Bottleneck``)."""

    def __init__(self, in_chs: int, out_chs: int, se_ratio: float, dtype: torch.dtype):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chs, out_chs, 1, bias=False, dtype=dtype)
        self.norm1 = LayerNorm(out_chs)
        # group_size 1 in timm: groups == width, a depthwise 3x3.
        self.conv2 = nn.Conv2d(out_chs, out_chs, 3, padding=1, groups=out_chs, bias=False, dtype=dtype)
        self.norm2 = LayerNorm(out_chs)
        self.se = (SqueezeExcite(out_chs, max(1, int(round(in_chs * se_ratio))), dtype)
                   if se_ratio else None)
        self.conv3 = nn.Conv2d(out_chs, out_chs, 1, bias=False, dtype=dtype)
        self.norm3 = LayerNorm(out_chs)
        if in_chs != out_chs:
            self.downsample_conv = nn.Conv2d(in_chs, out_chs, 1, bias=False, dtype=dtype)
            self.downsample_norm = LayerNorm(out_chs)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C_in) -> (N, H, W, C_out)."""
        h = F.silu(self.norm1(_conv1x1(x, self.conv1)))
        h = self.conv2(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h = F.silu(self.norm2(h))
        if self.se is not None:
            h = self.se(h)
        h = self.norm3(_conv1x1(h, self.conv3))
        shortcut = x
        if self.downsample_conv is not None:
            shortcut = self.downsample_norm(_conv1x1(x, self.downsample_conv))
        return F.silu(h + shortcut)


class RegStage(nn.Module):
    def __init__(self, depth: int, in_chs: int, out_chs: int, se_ratio: float, dtype: torch.dtype):
        super().__init__()
        for i in range(depth):
            self.add_module(f"b{i + 1}", RegBottleneck(in_chs if i == 0 else out_chs, out_chs,
                                                       se_ratio, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class STCConnector(nn.Module):
    def __init__(self, cfg: STCConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        self.s1 = RegStage(cfg.depth, cfg.encoder_hidden_size, c, cfg.se_ratio, cfg.dtype)
        self.sampler_conv = nn.Conv3d(c, c, 2, stride=2, padding=1, dtype=cfg.dtype)
        self.s2 = RegStage(cfg.depth, c, c, cfg.se_ratio, cfg.dtype)
        widths = [c] + [cfg.output_hidden_size] * cfg.mlp_depth
        self.readout = nn.ModuleList(nn.Linear(i, o, dtype=cfg.dtype) for i, o in zip(widths, widths[1:]))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C_enc) CLIP patch grid -> (B, T' * H' * W', E)."""
        cfg = self.cfg
        b, t, h, w, c = features.shape
        x = self.s1(features.to(cfg.dtype).reshape(b * t, h, w, c))
        x = x.reshape(b, t, h, w, cfg.hidden_size)
        x = self.sampler_conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        x = F.silu(x)
        _, td, hd, wd, _ = x.shape
        x = self.s2(x.reshape(b * td, hd, wd, cfg.hidden_size))
        x = self.readout[0](x)
        for layer in self.readout[1:]:
            x = layer(F.gelu(x))
        return x.reshape(b, td * hd * wd, cfg.output_hidden_size)
