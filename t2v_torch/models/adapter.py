"""The T2I-Adapter feature pyramid (depth-conditioned VideoCrafter), in
PyTorch.

The port of the JAX package's ``models/adapter.py``: PixelUnshuffle(8) ->
``conv_in`` -> four stages of ``nums_rb`` ResNet blocks (the first block of
stages 1-3 downsamples 2x, by a stride-2 conv or a 2x2 average pool) -> the
four stages' outputs, at the scales of the UNet's encoder levels. The UNet
adds them after every third input block.

The modules carry the published checkpoint's names (``conv_in``,
``body.N.{down_opt.op, in_conv, block1, block2, skep}``), so a checkpoint
loads with ``convert.load_state`` and needs no converter. Convolutions run
NCHW; ``Adapter.forward`` takes and returns channels-last tensors, permuted
once at each end.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


def pixel_unshuffle(x: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, C·f·f) in torch's PixelUnshuffle channel
    order (C-major, then row, then column), as the JAX package's
    space-to-depth reshape orders it."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // factor, w // factor, c * factor * factor)


class _Downsample(nn.Module):
    """A stride-2 3x3 conv (key ``op``), or a 2x2 average pool."""

    def __init__(self, channels: int, use_conv: bool):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, 2, 1) if use_conv else None

    def forward(self, x):
        return self.op(x) if self.op is not None else F.avg_pool2d(x, 2, 2)


class AdapterResnetBlock(nn.Module):
    """[downsample] -> [in_conv] -> block1 (3x3) -> ReLU -> block2 (+ skep,
    or + the input when ``sk``). NCHW."""

    def __init__(self, in_c: int, out_c: int, down: bool = False, ksize: int = 3,
                 sk: bool = False, use_conv: bool = True):
        super().__init__()
        pad = ksize // 2
        self.down_opt = _Downsample(in_c, use_conv) if down else None
        self.in_conv = (nn.Conv2d(in_c, out_c, ksize, 1, pad)
                        if in_c != out_c or not sk else None)
        self.block1 = nn.Conv2d(out_c, out_c, 3, 1, 1)
        self.block2 = nn.Conv2d(out_c, out_c, ksize, 1, pad)
        self.skep = None if sk else nn.Conv2d(out_c, out_c, ksize, 1, pad)

    def forward(self, x):
        if self.down_opt is not None:
            x = self.down_opt(x)
        if self.in_conv is not None:
            x = self.in_conv(x)
        h = self.block2(F.relu(self.block1(x)))
        return h + (self.skep(x) if self.skep is not None else x)


@dataclass(frozen=True)
class AdapterConfig:
    channels: tuple[int, ...] = (320, 640, 1280, 1280)
    nums_rb: int = 3
    cin: int = 64  # a 1-channel depth map after the 8x8 unshuffle
    unshuffle: int = 8
    ksize: int = 3
    sk: bool = False
    use_conv: bool = True

    @classmethod
    def depth_adapter(cls) -> "AdapterConfig":
        """The published VideoCrafter depth adapter: two blocks a stage,
        1x1 in/out convs, identity skips, pooled downsampling."""
        return cls(nums_rb=2, ksize=1, sk=True, use_conv=False)


class Adapter(nn.Module):
    """forward(x) -> one feature map per stage.

    x: (B, H, W, C_img) conditioning image (a depth map: C_img = 1)
    returns ((B, H/8, W/8, c0), (B, H/16, W/16, c1), ...), channels-last
    """

    def __init__(self, cfg: AdapterConfig = AdapterConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv_in = nn.Conv2d(cfg.cin, cfg.channels[0], 3, 1, 1)
        blocks = []
        for i, ch in enumerate(cfg.channels):
            for j in range(cfg.nums_rb):
                down = i != 0 and j == 0
                blocks.append(AdapterResnetBlock(cfg.channels[i - 1] if down else ch, ch, down,
                                                 cfg.ksize, cfg.sk, cfg.use_conv))
        self.body = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        cfg = self.cfg
        x = pixel_unshuffle(x.to(self.conv_in.weight.dtype), cfg.unshuffle)
        x = self.conv_in(x.permute(0, 3, 1, 2))
        features = []
        for i in range(len(cfg.channels)):
            for j in range(cfg.nums_rb):
                x = self.body[i * cfg.nums_rb + j](x)
            features.append(x.permute(0, 2, 3, 1))
        return tuple(features)


def infer_adapter_config(sd) -> AdapterConfig:
    """The config of an adapter checkpoint, read from its keys and shapes
    (the ``adapter.`` prefix already stripped)."""
    n_body = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("body."))
    outs = [sd[f"body.{i}.block1.weight"].shape[0] for i in range(n_body)]
    nums_rb = next((i for i in range(1, n_body) if outs[i] != outs[0]), n_body)
    conv_in = sd["conv_in.weight"]
    channels = tuple(outs[i] for i in range(0, n_body, nums_rb))
    if channels[0] != conv_in.shape[0]:
        raise ValueError(f"adapter checkpoint: conv_in has {conv_in.shape[0]} outputs, the "
                         f"first stage {channels[0]} channels")
    return AdapterConfig(
        channels=channels, nums_rb=nums_rb, cin=conv_in.shape[1],
        ksize=sd["body.0.block2.weight"].shape[-1], sk="body.0.skep.weight" not in sd,
        use_conv=any(".down_opt.op.weight" in k for k in sd),
    )
