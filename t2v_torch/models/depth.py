"""The monocular depth stage of the depth-adapter path, in PyTorch.

The port of the JAX package's ``models/depth.py``. LVDM's adapter path takes
an ordinary RGB video and computes its depth in the model
(``get_batch_depth``): each frame is resized to 384x384 (bicubic), a MiDaS
network predicts its inverse depth, the prediction is resized to the
request's size and min-max normalised per frame to [-1, 1].

* ``prepare_depth_frames`` / ``normalize_depth``: that contract, the first
  on the host (cv2), the second on the device. The resizes are the JAX
  package's ``jax.image`` ones, as host-built weight matrices applied by two
  products (``resize_matrix``): Keys cubic with a = -0.5 that antialiases
  when it shrinks (torch's bicubic uses a = -0.75 and does not), and the
  decoder's 2x bilinear upsampling;
* ``MidasSmall``: MiDaS v2.1 small (an EfficientNet-Lite3 encoder, the
  expanding RefineNet decoder with 64 features, a non-negative head). Its
  modules carry ``midas_v21_small``'s state-dict names (``pretrained.
  layerN``, ``scratch.layerN_rn``, ``scratch.refinenetN``,
  ``scratch.output_conv``), so a checkpoint loads by ``load_state``; the
  BatchNorms (eps 1e-3) run in eval mode until ``fold_batchnorm`` folds them
  into their convolutions, which ``DepthStage.from_checkpoint`` does in
  float32 before casting, as the JAX converter folds them;
* ``DepthStage``: the estimator (the network, or any callable the caller
  injects, as tests do) and ``video_depth``, in chunks of 8 frames on the
  pipeline's device.

Convolutions run NCHW; ``MidasSmall.forward`` takes channels-last frames and
permutes once.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from t2v_torch.core.dtypes import Policy

# EfficientNet-Lite3 (width 1.2, depth 1.4; the lite variants fix the stem at
# 32 channels, drop squeeze-excite and use ReLU6):
#   (repeats, kernel, stride, expand_ratio, out_channels)
_LITE3_STAGES: tuple[tuple[int, int, int, int, int], ...] = (
    (1, 3, 1, 1, 24),
    (3, 3, 2, 6, 32),
    (3, 5, 2, 6, 48),
    (5, 3, 2, 6, 96),
    (5, 5, 1, 6, 136),
    (6, 5, 2, 6, 232),
    (1, 3, 1, 6, 384),
)
# the stages behind each of MidasNet_small's four taps (pretrained.layer1 is
# the stem and stages 0-1, stride 4; layer2 stage 2; layer3 stages 3-4;
# layer4 stages 5-6, stride 32)
_TAPS = ((0, 2), (2, 3), (3, 5), (5, 7))
_TAP_CH = (32, 48, 136, 384)
_DEC_CH = (64, 128, 256, 512)  # scratch.layerN_rn (64 features, expanding)
BN_EPS = 1e-3  # tf_efficientnet_lite BatchNorm epsilon


# ---------------------------------------------------------------------------
# jax.image's resize, as weight matrices


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int, scale: float, kernel: str) -> np.ndarray:
    """(out_size, in_size) float32 weights of ``jax.image.scale_and_translate``
    along one axis at translation 0, antialiased (its default): output pixel
    o samples the input at (o + 0.5) / scale - 0.5 with the kernel widened
    by 1 / scale when shrinking; each row is normalised, and a row whose
    sample lies outside the input is 0."""
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv - 0.5
    w = _KERNELS[kernel](np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def _resize_hw(x: torch.Tensor, hw: tuple[int, int], scales: tuple[float, float],
               kernel: str) -> torch.Tensor:
    """(..., H, W) -> (..., h, w) through the two weight matrices."""
    mats = [torch.from_numpy(resize_matrix(n, m, s, kernel)).to(x.device, x.dtype)
            for n, m, s in zip(x.shape[-2:], hw, scales)]
    return torch.einsum("oh,...hw,pw->...op", mats[0], x, mats[1])


def resize(x: torch.Tensor, hw: tuple[int, int], kernel: str = "cubic") -> torch.Tensor:
    """``jax.image.resize`` of (..., H, W) to ``hw`` (antialiased, scale
    out / in); an axis of unchanged size is left as it is."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return _resize_hw(x, hw, (hw[0] / x.shape[-2], hw[1] / x.shape[-1]), kernel)


def resize_bilinear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """The JAX package's ``_resize_bilinear(align_corners=True)`` on
    (..., H, W): ``scale_and_translate`` with the linear kernel at scale
    (out - 1) / (in - 1) per axis and translation 0. Samples sit at
    (o + 0.5) / scale - 0.5, which is not torch's ``align_corners=True``
    grid (o / scale)."""
    h, w = x.shape[-2:]
    nh, nw = hw
    if nh > 1 and nw > 1:
        return _resize_hw(x, hw, ((nh - 1) / max(h - 1, 1), (nw - 1) / max(w - 1, 1)), "linear")
    return resize(x, hw, "linear")


# ---------------------------------------------------------------------------
# MiDaS v2.1 small


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    """A bias-free conv then eval-mode BatchNorm as one biased conv:
    W' = W·s, b' = beta - mean·s, s = gamma / sqrt(var + eps)."""
    with torch.no_grad():
        s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
        out = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
                        conv.padding, groups=conv.groups, bias=True,
                        device=conv.weight.device, dtype=conv.weight.dtype)
        out.weight.copy_(conv.weight.float() * s[:, None, None, None])
        out.bias.copy_(bn.bias.float() - bn.running_mean.float() * s)
    return out


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=bias)


class DepthwiseSeparable(nn.Module):
    """Stage 0 (expand ratio 1): depthwise conv + BN + ReLU6, pointwise conv
    + BN, a residual where the shape allows."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.conv_dw, self.bn1 = _conv(cin, cin, k, stride, groups=cin), _bn(cin)
        self.conv_pw, self.bn2 = _conv(cin, cout, 1), _bn(cout)
        self.skip = stride == 1 and cin == cout

    def fold(self) -> None:
        self.conv_dw, self.bn1 = _fold(self.conv_dw, self.bn1), nn.Identity()
        self.conv_pw, self.bn2 = _fold(self.conv_pw, self.bn2), nn.Identity()

    def forward(self, x):
        h = self.bn2(self.conv_pw(F.relu6(self.bn1(self.conv_dw(x)))))
        return h + x if self.skip else h


class InvertedResidual(nn.Module):
    """Inverted residual without squeeze-excite: pointwise expand + BN +
    ReLU6, depthwise + BN + ReLU6, pointwise project + BN, a residual where
    the shape allows."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, expand: int):
        super().__init__()
        mid = cin * expand
        self.conv_pw, self.bn1 = _conv(cin, mid, 1), _bn(mid)
        self.conv_dw, self.bn2 = _conv(mid, mid, k, stride, groups=mid), _bn(mid)
        self.conv_pwl, self.bn3 = _conv(mid, cout, 1), _bn(cout)
        self.skip = stride == 1 and cin == cout

    def fold(self) -> None:
        self.conv_pw, self.bn1 = _fold(self.conv_pw, self.bn1), nn.Identity()
        self.conv_dw, self.bn2 = _fold(self.conv_dw, self.bn2), nn.Identity()
        self.conv_pwl, self.bn3 = _fold(self.conv_pwl, self.bn3), nn.Identity()

    def forward(self, x):
        h = F.relu6(self.bn1(self.conv_pw(x)))
        h = F.relu6(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.skip else h


class ResidualConvUnit(nn.Module):
    """ReLU, 3x3 conv, ReLU, 3x3 conv, plus the input."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv(features, features, 3, bias=True)
        self.conv2 = _conv(features, features, 3, bias=True)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """[x + resConfUnit1(skip)] -> resConfUnit2 -> 2x bilinear -> 1x1
    out_conv. ``resConfUnit1`` exists in every block, as in the checkpoint,
    and the deepest block has no skip to run it on."""

    def __init__(self, features: int, out_features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = _conv(features, out_features, 1, bias=True)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        return self.out_conv(x)


class _Upsample2x(nn.Module):
    def forward(self, x):
        return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


@dataclass(frozen=True)
class MidasSmallConfig:
    stages: tuple = _LITE3_STAGES
    taps: tuple = _TAPS
    tap_ch: tuple = _TAP_CH
    dec_ch: tuple = _DEC_CH
    head_ch: int = 32

    def tiny(self) -> "MidasSmallConfig":
        """The same topology at one block a stage and an eighth of the
        widths (CPU tests)."""
        stages = tuple((1, k, s, e, max(8, c // 8)) for (_, k, s, e, c) in self.stages)
        return MidasSmallConfig(stages=stages, taps=self.taps,
                                tap_ch=tuple(stages[hi - 1][4] for _, hi in self.taps),
                                dec_ch=(8, 16, 32, 64), head_ch=8)


class _Encoder(nn.Module):
    """``pretrained``: layer1 = conv_stem, bn1, ReLU6 and the stages of the
    first tap; layer2-4 the stages of the others, each stage a Sequential of
    its blocks."""

    def __init__(self, cfg: MidasSmallConfig):
        super().__init__()
        cin = 32
        stages = []
        for reps, k, s, e, c in cfg.stages:
            blocks = []
            for r in range(reps):
                stride = s if r == 0 else 1
                blocks.append(DepthwiseSeparable(cin, c, k, stride) if e == 1
                              else InvertedResidual(cin, c, k, stride, e))
                cin = c
            stages.append(nn.Sequential(*blocks))
        groups = [stages[lo:hi] for lo, hi in cfg.taps]
        self.layer1 = nn.Sequential(_conv(3, 32, 3, 2), _bn(32), nn.ReLU6(), *groups[0])
        self.layer2 = nn.Sequential(*groups[1])
        self.layer3 = nn.Sequential(*groups[2])
        self.layer4 = nn.Sequential(*groups[3])

    def forward(self, x):
        taps = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            taps.append(x)
        return taps


class _Decoder(nn.Module):
    """``scratch``: the four bias-free tap projections, the top-down fusion
    blocks (refinenet4 to refinenet1, each halving the features but the
    last) and the head (3x3 conv, 2x bilinear, 3x3 conv, ReLU, 1x1 conv,
    ReLU)."""

    def __init__(self, cfg: MidasSmallConfig):
        super().__init__()
        d = cfg.dec_ch
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn", _conv(cfg.tap_ch[i], d[i], 3))
        self.refinenet4 = FeatureFusionBlock(d[3], d[2])
        self.refinenet3 = FeatureFusionBlock(d[2], d[1])
        self.refinenet2 = FeatureFusionBlock(d[1], d[0])
        self.refinenet1 = FeatureFusionBlock(d[0], d[0])
        self.output_conv = nn.Sequential(
            _conv(d[0], cfg.head_ch, 3, bias=True), _Upsample2x(),
            _conv(cfg.head_ch, cfg.head_ch, 3, bias=True), nn.ReLU(),
            _conv(cfg.head_ch, 1, 1, bias=True), nn.ReLU(), nn.Identity())

    def forward(self, taps):
        rn = [getattr(self, f"layer{i + 1}_rn")(t) for i, t in enumerate(taps)]
        p = self.refinenet4(rn[3])
        p = self.refinenet3(p, rn[2])
        p = self.refinenet2(p, rn[1])
        p = self.refinenet1(p, rn[0])
        return self.output_conv(p)


class MidasSmall(nn.Module):
    """forward(x) -> inverse depth.

    x: (B, H, W, 3) RGB in [-1, 1], channels-last
    returns (B, H, W) float32, non-negative (relative inverse depth)
    """

    def __init__(self, cfg: MidasSmallConfig | None = None):
        super().__init__()
        self.cfg = cfg or MidasSmallConfig()
        self.pretrained = _Encoder(self.cfg)
        self.scratch = _Decoder(self.cfg)

    def fold_batchnorm(self) -> "MidasSmall":
        """Fold every BatchNorm into its convolution (in the convolution's
        dtype; load float32 and fold before casting)."""
        stem = self.pretrained.layer1
        stem[0], stem[1] = _fold(stem[0], stem[1]), nn.Identity()
        for m in self.modules():
            if isinstance(m, (DepthwiseSeparable, InvertedResidual)):
                m.fold()
        return self

    def forward(self, x):
        w = self.pretrained.layer1[0].weight
        y = self.scratch(self.pretrained(x.to(w.dtype).permute(0, 3, 1, 2)))
        return y[:, 0].float()


# ---------------------------------------------------------------------------
# get_batch_depth


def prepare_depth_frames(frames_rgb: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) uint8 or float RGB -> (N, 384, 384, 3) float32 in
    [-1, 1]: bicubic (cv2) to 384x384, on the host."""
    import cv2

    f = np.asarray(frames_rgb)
    if f.dtype == np.uint8:
        f = f.astype(np.float32) / 255.0 * 2.0 - 1.0
    return np.stack([cv2.resize(fr, (384, 384), interpolation=cv2.INTER_CUBIC)
                     for fr in f]).astype(np.float32)


def normalize_depth(depth: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """(N, h, w) raw prediction -> (N, H, W, 1) float32 in [-1, 1]: the
    antialiased Keys-cubic resize to the target, then min-max per frame."""
    d = resize(depth.float(), tuple(target_hw), "cubic")[..., None]
    dmin = d.amin(dim=(1, 2, 3), keepdim=True)
    dmax = d.amax(dim=(1, 2, 3), keepdim=True)
    return 2.0 * (d - dmin) / (dmax - dmin + 1e-7) - 1.0


@dataclass
class DepthStage:
    """The adapter path's depth stage. ``estimator`` maps (N, 384, 384, 3)
    float32 frames in [-1, 1] on ``device`` to (N, h, w) float32 depth: the
    MiDaS network, or a stub in tests."""

    estimator: Callable[[torch.Tensor], torch.Tensor]
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, policy: Policy = Policy(), *,
                        device: torch.device | str = "cuda",
                        cfg: MidasSmallConfig | None = None) -> "DepthStage":
        """A ``midas_v21_small`` torch checkpoint (optionally under
        ``state_dict``), read weights-only, folded in float32 on ``device``
        and cast to the policy's dtype."""
        from t2v_torch.io import convert

        dev = torch.device(device)
        sd = convert.load_torch_checkpoint(ckpt_path)
        sd = sd.get("state_dict", sd)
        with torch.device("meta"):
            model = MidasSmall(cfg)
        # a training counter, not a weight: a checkpoint need not carry it
        sd = {**{k: torch.zeros(()) for k in model.state_dict()
                 if k.endswith("num_batches_tracked")}, **sd}
        try:
            convert.load_state(model, sd, dtype=torch.float32, device=dev)
        except KeyError as e:
            raise KeyError(f"{ckpt_path}: not a midas_v21_small checkpoint: {e}") from None
        return cls(estimator=model.fold_batchnorm().to(policy.param_dtype).eval(), device=dev)

    @torch.no_grad()
    def video_depth(self, frames_rgb: np.ndarray, target_hw: tuple[int, int],
                    chunk: int = 8) -> torch.Tensor:
        """Per-frame depth in [-1, 1] at ``target_hw``: (N, H, W, 1) float32
        on the stage's device, estimated ``chunk`` frames at a time."""
        prepped = prepare_depth_frames(frames_rgb)
        outs = []
        for i in range(0, prepped.shape[0], chunk):
            x = torch.from_numpy(prepped[i:i + chunk]).to(self.device)
            outs.append(normalize_depth(self.estimator(x), target_hw))
        return torch.cat(outs)
