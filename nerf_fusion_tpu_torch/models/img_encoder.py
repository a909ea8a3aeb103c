"""Pixel-aligned image encoders (the pixelNeRF-style family).

Counterpart of the JAX package's ``models/img_encoder.py`` (the reference
fork's ``trainer/img_encoder.py``), as ``nn.Module``s whose parameters
carry the JAX pytree's keys (``stem.w``, ``conv0a.b``, ``fc.w``, ...):

  * ``SpatialEncoder`` — conv stages whose feature maps are upsampled to
    the first stage's resolution and concatenated; ``index_features``
    samples them at pixels of the original image;
  * ``ImageEncoder``   — conv stages, global average pool, linear head;
  * ``ConvEncoder``    — a small encoder-decoder giving per-pixel features;
  * ``ResNetBackbone`` — ResNet-18 / -34 in torchvision's module layout,
    so ``import_torch_backbone`` is a ``load_state_dict``; its BatchNorm is
    frozen (running statistics, eps 1e-5).

The convolutions are ``F.conv2d`` (cuDNN on the card), as the JAX package
leaves them to XLA.  The encoders' ``conv2d`` pads as XLA's ``"SAME"``
does, which is asymmetric under stride 2 (for an even size: 2 before and
3 after at k = 7, 0 and 1 at k = 3); the ResNet pads symmetrically, as
torchvision does.  Group norm: gcd(8, C) groups, biased variance, eps
1e-5, no affine.  Upsampling: bilinear with align_corners, a size of 1
copying the first row or column.

Precision: products in f32.  cuDNN convolves in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False, and the port's entry points
and ``chip_smoke.py`` set it False; a caller that leaves it on gets TF32.
``models.io`` carries the JAX package's weights across.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .decoder import _linear_init, _uniform


class _Conv(nn.Module):
    """A k x k convolution with bias, ``w`` (out, in, k, k), drawn as the
    JAX ``_conv_init`` draws it (uniform in +-1/sqrt(fan_in))."""

    def __init__(self, c_in: int, c_out: int, k: int, gen: torch.Generator):
        super().__init__()
        bound = math.sqrt(1.0 / (c_in * k * k))
        self.w = nn.Parameter(_uniform((c_out, c_in, k, k), bound, gen))
        self.b = nn.Parameter(_uniform((c_out,), bound, gen))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return conv2d_same(x, self.w, self.b, stride)


def same_padding(size: int, k: int, stride: int) -> tuple:
    """XLA's ``"SAME"`` padding of one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1):
    """NCHW convolution padded as XLA's ``"SAME"``."""
    k_h, k_w = w.shape[2], w.shape[3]
    ph, pw = same_padding(x.shape[2], k_h, stride), same_padding(x.shape[3], k_w, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, b, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, b, stride=stride)


def group_norm(x: torch.Tensor, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    return F.group_norm(x, math.gcd(groups, x.shape[1]), eps=eps)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, h, w), bilinear with align_corners; an input
    or output size of 1 takes the first row or column."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def _relu_gn(x):
    return torch.relu(group_norm(x))


class SpatialEncoderConfig(NamedTuple):
    channels: tuple = (64, 128, 256, 512)
    latent_size: int = 960          # the stage channels concatenated
    in_channels: int = 3


class SpatialEncoder(nn.Module):
    """(B, 3, H, W) -> (B, sum(channels), H/2, W/2) pixel-aligned latent."""

    def __init__(self, cfg: SpatialEncoderConfig = SpatialEncoderConfig(),
                 gen: torch.Generator = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.config = cfg
        self.stem = _Conv(cfg.in_channels, cfg.channels[0], 7, gen)
        c_prev = cfg.channels[0]
        for i, c in enumerate(cfg.channels):
            self.add_module(f"conv{i}a", _Conv(c_prev, c, 3, gen))
            self.add_module(f"conv{i}b", _Conv(c, c, 3, gen))
            c_prev = c

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = _relu_gn(self.stem(images, stride=2))
        feats = []
        for i in range(len(self.config.channels)):
            x = _relu_gn(getattr(self, f"conv{i}a")(x, stride=1 if i == 0 else 2))
            x = _relu_gn(getattr(self, f"conv{i}b")(x))
            feats.append(x)
        h, w = feats[0].shape[2], feats[0].shape[3]
        return torch.cat([feats[0]] + [resize_bilinear(f, h, w) for f in feats[1:]], 1)


def index_features(latent: torch.Tensor, uv: torch.Tensor, image_hw) -> torch.Tensor:
    """Pixel-aligned bilinear lookup: ``latent`` (B, C, h, w) at ``uv``
    (B, N, 2), pixel coordinates of the original (H, W) image scaled by
    (w - 1) / (W - 1); a coordinate outside the map takes the nearest edge
    (the JAX ``map_coordinates(order=1, mode="nearest")``).
    :return: (B, C, N)."""
    H, W = image_hw
    grid = torch.stack([uv[..., 0] * (2.0 / (W - 1)) - 1.0,
                        uv[..., 1] * (2.0 / (H - 1)) - 1.0], -1)
    out = F.grid_sample(latent, grid[:, None].to(latent.dtype), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[:, :, 0, :]


class ImageEncoderConfig(NamedTuple):
    channels: tuple = (32, 64, 128, 256)
    latent_size: int = 128
    in_channels: int = 3


class ImageEncoder(nn.Module):
    """(B, 3, H, W) -> (B, latent_size) global feature."""

    def __init__(self, cfg: ImageEncoderConfig = ImageEncoderConfig(),
                 gen: torch.Generator = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.config = cfg
        c_prev = cfg.in_channels
        for i, c in enumerate(cfg.channels):
            self.add_module(f"conv{i}", _Conv(c_prev, c, 3, gen))
            c_prev = c
        w, b = _linear_init(c_prev, cfg.latent_size, gen)
        self.fc = nn.Module()
        self.fc.w, self.fc.b = nn.Parameter(w), nn.Parameter(b)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images
        for i in range(len(self.config.channels)):
            x = _relu_gn(getattr(self, f"conv{i}")(x, stride=2))
        return x.mean(dim=(2, 3)) @ self.fc.w.T + self.fc.b


class ConvEncoderConfig(NamedTuple):
    channels: tuple = (32, 64, 128)
    out_channels: int = 32
    in_channels: int = 3


class ConvEncoder(nn.Module):
    """(B, 3, H, W) -> (B, out_channels, H, W) UNet-like per-pixel features
    (H and W multiples of 2^len(channels))."""

    def __init__(self, cfg: ConvEncoderConfig = ConvEncoderConfig(),
                 gen: torch.Generator = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.config = cfg
        n = len(cfg.channels)
        c_prev = cfg.in_channels
        for i, c in enumerate(cfg.channels):
            self.add_module(f"down{i}", _Conv(c_prev, c, 3, gen))
            c_prev = c
        for i in range(n - 1, -1, -1):
            c_out = cfg.channels[i - 1] if i > 0 else cfg.out_channels
            self.add_module(f"up{i}", _Conv(c_prev, c_out, 3, gen))
            c_prev = c_out + (cfg.channels[i - 1] if i > 0 else 0)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        skips, x = [], images
        n = len(self.config.channels)
        for i in range(n):
            x = _relu_gn(getattr(self, f"down{i}")(x, stride=2))
            skips.append(x)
        for i in range(n - 1, -1, -1):
            h, w = x.shape[2] * 2, x.shape[3] * 2
            x = _relu_gn(getattr(self, f"up{i}")(resize_bilinear(x, h, w)))
            if i > 0:
                x = torch.cat([x, resize_bilinear(skips[i - 1], h, w)], 1)
        return x


# -- ResNet-18/34 backbone (the reference SpatialEncoder's) -----------------


class ResNetBackboneConfig(NamedTuple):
    depth: int = 18                  # 18 or 34
    num_stages: int = 4              # feature stages concatenated (1..4)
    latent_size: int = 512           # 64 + 64 + 128 + 256 at num_stages 4


RESNET_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
_BN_EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on its running statistics (torchvision's key names); the
    scale and shift are parameters."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + _BN_EPS) * self.weight
        return x * inv[None, :, None, None] + (
            self.bias - self.running_mean * inv)[None, :, None, None]


def _conv_nobias(c_in: int, c_out: int, k: int, stride: int, pad: int,
                 gen: torch.Generator) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, k, stride, pad, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                          * math.sqrt(2.0 / (c_in * k * k)))
    return conv


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, gen: torch.Generator):
        super().__init__()
        self.conv1 = _conv_nobias(c_in, c_out, 3, stride, 1, gen)
        self.bn1 = FrozenBatchNorm2d(c_out)
        self.conv2 = _conv_nobias(c_out, c_out, 3, 1, 1, gen)
        self.bn2 = FrozenBatchNorm2d(c_out)
        self.downsample = None
        if stride != 1 or c_in != c_out:
            self.downsample = nn.Sequential(_conv_nobias(c_in, c_out, 1, stride, 0, gen),
                                            FrozenBatchNorm2d(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idt = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + idt)


class ResNetBackbone(nn.Module):
    """(B, 3, H, W) -> (B, latent_size, H/2, W/2): the stem's map and the
    first ``num_stages - 1`` stages' maps upsampled to it and concatenated
    (the reference SpatialEncoder's latent).  Weights He-normal from
    ``gen``; all four stages are built, as the JAX package builds them."""

    def __init__(self, cfg: ResNetBackboneConfig = ResNetBackboneConfig(),
                 gen: torch.Generator = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.config = cfg
        self.conv1 = _conv_nobias(3, 64, 7, 2, 3, gen)
        self.bn1 = FrozenBatchNorm2d(64)
        c_in = 64
        for li, (n_blocks, c_out) in enumerate(zip(RESNET_BLOCKS[cfg.depth],
                                                   (64, 128, 256, 512)), start=1):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(BasicBlock(c_in, c_out, 2 if (li > 1 and bi == 0) else 1, gen))
                c_in = c_out
            self.add_module(f"layer{li}", nn.Sequential(*blocks))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(images)))
        feats = [x]
        if self.config.num_stages > 1:
            x = F.max_pool2d(x, 3, 2, 1)      # pads with -inf
        for li in range(1, self.config.num_stages):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        h, w = feats[0].shape[2], feats[0].shape[3]
        return torch.cat([feats[0]] + [resize_bilinear(f, h, w) for f in feats[1:]], 1)


def import_torch_backbone(state_dict, depth: int = 18,
                          cfg: ResNetBackboneConfig = None) -> ResNetBackbone:
    """A torchvision ``resnet{18,34}`` state dict (or the path of a ``.pth``
    holding one) -> ``ResNetBackbone``; ``fc.*`` and
    ``num_batches_tracked`` entries are left out."""
    if not hasattr(state_dict, "items"):
        state_dict = torch.load(state_dict, map_location="cpu", weights_only=True)
    sd = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in state_dict.items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    net = ResNetBackbone(cfg if cfg is not None else ResNetBackboneConfig(depth=depth))
    net.load_state_dict(sd)
    return net


ENCODERS = {"spatial": (SpatialEncoderConfig, SpatialEncoder),
            "global": (ImageEncoderConfig, ImageEncoder),
            "conv": (ConvEncoderConfig, ConvEncoder),
            "resnet": (ResNetBackboneConfig, ResNetBackbone)}


def make_encoder(enc_type: str = "spatial", gen: torch.Generator = None, **kwargs):
    """The encoder of ``enc_type`` (spatial, global, conv, resnet) with its
    config from ``kwargs`` and weights from ``gen``."""
    if enc_type not in ENCODERS:
        raise NotImplementedError(enc_type)
    cfg_cls, cls = ENCODERS[enc_type]
    return cls(cfg_cls(**kwargs), gen)
