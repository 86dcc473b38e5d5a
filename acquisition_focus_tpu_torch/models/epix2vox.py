"""EPix2Vox / Pix2Vox multi-view 3D reconstruction baselines (torch port of
``acquisition_focus_tpu/models/epix2vox.py``).

A ResNet50-stem 2D encoder over 224^2 3-channel view renderings, a per-view 3D
transposed-conv decoder (2^3 -> 128^3), a context-aware merger (softmax view
weighting) and a residual refiner, which neither package's forward calls (so it
is not part of ``EPix2VoxModel128`` and holds no parameters of it).

Layout: the port is channels-first where the JAX package is channels-last. Three
reshapes of the JAX model act on channels-last tensors; the port reproduces the
order of their elements, not only their shapes: the encoder's (B, V, 8, 8, 256)
features (with ``use_epix2vox``, the cross-view 3D conv takes the view axis as
its channel axis over the (8, 8, 256) grid), the decoder's (B*V, 2, 2, 2, 2048)
start, and the refiner's flatten around its dense layers.

As in the JAX package: Kaiming-normal initialization instead of ImageNet weights
(:func:`init_weights`), norms on the current batch's statistics in training and
evaluation alike (no running averages), and float32 compute whatever the stage's
``compute_dtype`` (autocast is off inside the model).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from acquisition_focus_tpu_torch.ops.channel_ops import channel_softmax, channel_sum


class BatchNorm(nn.Module):
    """Batch normalization on the current batch's statistics, in training and in
    evaluation: per-channel mean and biased variance over every axis but axis 1,
    in float32 (or wider), eps 1e-5, learned scale (``weight``, init 1) and
    ``bias`` (init 0)."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, torch.float32)
        y = F.batch_norm(x.to(dtype), None, None, self.weight.to(dtype),
                         self.bias.to(dtype), training=True, eps=self.eps)
        return y.to(x.dtype)


def _same_pad(x, kernel, stride):
    """flax's 'SAME' padding of a 2D conv: (total // 2, total - total // 2) per
    axis, which differs from torch's symmetric padding at stride 2."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Bottleneck(nn.Module):
    """ResNet bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (4x expansion); a 1x1
    projection on the residual where the channels or the stride change."""

    def __init__(self, in_channels, features, stride=1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, 4 * features, 1, bias=False)
        self.bn3 = BatchNorm(4 * features)
        if in_channels != 4 * features or stride != 1:
            self.down = nn.Conv2d(in_channels, 4 * features, 1, stride=stride, bias=False)
            self.bn_down = BatchNorm(4 * features)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(_same_pad(out, 3, self.stride))))
        out = self.bn3(self.conv3(out))
        residual = self.bn_down(self.down(x)) if hasattr(self, 'down') else x
        return F.relu(out + residual)


class ResNet50Stem(nn.Module):
    """conv1..layer2 of ResNet50: (N, 3, 224, 224) -> (N, 512, 28, 28)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        for i in range(3):                                     # layer1 @ 64
            self.add_module(f'l1_b{i}', Bottleneck(64 if i == 0 else 256, 64))
        for i in range(4):                                     # layer2 @ 128
            self.add_module(f'l2_b{i}', Bottleneck(256 if i == 0 else 512, 128,
                                                   stride=2 if i == 0 else 1))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)            # pads with -inf
        for i in range(3):
            x = getattr(self, f'l1_b{i}')(x)
        for i in range(4):
            x = getattr(self, f'l2_b{i}')(x)
        return x


class Epix2VoxEncoder(nn.Module):
    """Per-view features (B, V, 3, 224, 224) -> (B, V, 8, 8, 256) in the JAX
    package's element order; with ``use_epix2vox`` the cross-view 3D conv fuses
    the views into one: (B, 1, 8, 8, 256)."""

    def __init__(self, n_views, use_epix2vox=True, leaky=0.2):
        super().__init__()
        self.use_epix2vox = use_epix2vox
        self.leaky = leaky
        self.resnet = ResNet50Stem()
        self.l1_conv = nn.Conv2d(512, 512, 3)
        self.l1_bn = BatchNorm(512)
        self.l2_conv = nn.Conv2d(512, 512, 3)
        self.l2_bn = BatchNorm(512)
        self.l3_conv = nn.Conv2d(512, 256, 1)
        self.l3_bn = BatchNorm(256)
        if use_epix2vox:
            self.l4_conv = nn.Conv3d(n_views, 1, 3, padding=1)
            self.l4_bn = BatchNorm(1)

    def forward(self, views):
        B, V = views.shape[:2]
        x = self.resnet(views.reshape((B * V,) + tuple(views.shape[2:])))
        x = F.elu(self.l1_bn(self.l1_conv(x)))                 # (BV, 512, 26, 26)
        x = F.elu(self.l2_bn(self.l2_conv(x)))                 # (BV, 512, 24, 24)
        x = F.max_pool2d(x, 3, stride=3)                       # (BV, 512, 8, 8)
        x = F.elu(self.l3_bn(self.l3_conv(x)))                 # (BV, 256, 8, 8)
        x = x.permute(0, 2, 3, 1).reshape(B, V, 8, 8, 256)
        if self.use_epix2vox:
            # channels = views, spatial = (8, 8, 256): the JAX package's
            # transpose to (B, 8, 8, 256, V) in channels-first terms
            x = F.leaky_relu(self.l4_bn(self.l4_conv(x)), self.leaky)
        return x


class Epix2VoxDecoder(nn.Module):
    """(B, V, 8, 8, 256) -> raw (B, V, 9, 128, 128, 128) features (8 decoder
    channels and the coarse volume), coarse (B, V, 128, 128, 128). The features
    start as (B*V, 2048, 2, 2, 2); ``in_features`` and ``features`` narrow the
    decoder (the model uses the defaults)."""

    def __init__(self, in_features=2048, features=(512, 128, 32, 32, 32, 8)):
        super().__init__()
        self.in_features = in_features
        self.features = tuple(features)
        ci = in_features
        for i, f in enumerate(self.features):
            # flax ConvTranspose 4^3, stride 2, 'SAME' (kernel flipped, convert.py)
            self.add_module(f'up{i}', nn.ConvTranspose3d(ci, f, 4, stride=2, padding=1,
                                                         bias=False))
            self.add_module(f'up{i}_bn', BatchNorm(f))
            ci = f
        self.head = nn.ConvTranspose3d(ci, 1, 1, bias=False)

    def forward(self, feats):
        B, V = feats.shape[:2]
        x = feats.reshape(B * V, 2, 2, 2, self.in_features).permute(0, 4, 1, 2, 3)
        for i in range(len(self.features)):
            x = F.relu(getattr(self, f'up{i}_bn')(getattr(self, f'up{i}')(x)))
        vol = torch.sigmoid(self.head(x))                      # (BV, 1, S, S, S)
        raw = torch.cat([x, vol], dim=1)
        S = raw.shape[-1]
        return raw.reshape(B, V, -1, S, S, S), vol.reshape(B, V, S, S, S)


class Epix2VoxMerger(nn.Module):
    """Context-aware merge: 3^3 convs 9 -> 16 -> 8 -> 4 -> 2 -> 1 on each view's
    raw features, a softmax over the views, and the weighted sum of the coarse
    volumes, clipped to [0, 1]."""
    FEATURES = (16, 8, 4, 2, 1)

    def __init__(self, leaky=0.2):
        super().__init__()
        self.leaky = leaky
        ci = 9
        for i, f in enumerate(self.FEATURES):
            self.add_module(f'm{i}_conv', nn.Conv3d(ci, f, 3, padding=1))
            self.add_module(f'm{i}_bn', BatchNorm(f))
            ci = f

    def forward(self, raw_features, coarse_volumes):
        B, V = raw_features.shape[:2]
        x = raw_features.reshape((B * V,) + tuple(raw_features.shape[2:]))
        for i in range(len(self.FEATURES)):
            x = getattr(self, f'm{i}_bn')(getattr(self, f'm{i}_conv')(x))
            x = F.leaky_relu(x, self.leaky)
        S = x.shape[-1]
        weights = channel_softmax(x.reshape(B, V, S, S, S))
        merged = channel_sum(coarse_volumes * weights, keepdims=False)
        return torch.clamp(merged, 0.0, 1.0)


class Epix2VoxRefiner(nn.Module):
    """Residual volume refiner: (B, 128, 128, 128) -> (B, 128, 128, 128). Its
    dense layers fix the input at 128^3 (4^3 x 128 = 8192 features). Neither
    package's ``EPix2VoxModel128`` calls it."""
    FEATURES = (8, 16, 32, 64, 128)
    UP = (64, 32, 16, 8)

    def __init__(self, leaky=0.2):
        super().__init__()
        self.leaky = leaky
        ci = 1
        for i, f in enumerate(self.FEATURES):
            self.add_module(f'r{i}_conv', nn.Conv3d(ci, f, 4, padding=2))
            self.add_module(f'r{i}_bn', BatchNorm(f))
            ci = f
        self.fc1 = nn.Linear(8192, 2048)
        self.fc2 = nn.Linear(2048, 8192)
        for i, f in enumerate(self.UP):
            self.add_module(f'u{i}', nn.ConvTranspose3d(ci, f, 4, stride=2, padding=1,
                                                        bias=False))
            self.add_module(f'u{i}_bn', BatchNorm(f))
            ci = f
        self.u_out = nn.ConvTranspose3d(ci, 1, 4, stride=2, padding=1, bias=False)

    def forward(self, vol):
        x = vol[:, None]
        for i in range(len(self.FEATURES)):
            x = getattr(self, f'r{i}_bn')(getattr(self, f'r{i}_conv')(x))
            x = F.max_pool3d(F.leaky_relu(x, self.leaky), 2, stride=2)
        B, C, D, H, W = x.shape
        h = x.permute(0, 2, 3, 4, 1).reshape(B, -1)           # channels-last flatten
        h = F.relu(self.fc2(F.relu(self.fc1(h))))
        x = h.reshape(B, D, H, W, C).permute(0, 4, 1, 2, 3)
        for i in range(len(self.UP)):
            x = F.relu(getattr(self, f'u{i}_bn')(getattr(self, f'u{i}')(x)))
        x = torch.sigmoid(self.u_out(x))
        return (vol + x[:, 0]) * 0.5


class EPix2VoxModel128(nn.Module):
    """Views (B, V, 3, 224, 224) -> occupancy volume (B, 128, 128, 128).
    ``use_epix2vox`` False is plain Pix2Vox (no cross-view fusion)."""

    def __init__(self, n_views, use_epix2vox=True, use_merger=True):
        super().__init__()
        self.use_merger = use_merger
        self.encoder = Epix2VoxEncoder(n_views, use_epix2vox)
        self.decoder = Epix2VoxDecoder()
        if use_merger:
            self.merger = Epix2VoxMerger()

    def forward(self, views):
        with torch.autocast(views.device.type, enabled=False):
            raw, coarse = self.decoder(self.encoder(views.float()))
            if self.use_merger:
                return self.merger(raw, coarse)
            return coarse.mean(dim=1)


@torch.no_grad()
def init_weights(model, generator):
    """The reference's ``init_weights``, as the JAX package draws it: Kaiming
    normal (std sqrt(2 / fan_in)) on every conv and transposed-conv weight, zero
    biases, normal(0, 0.01) on dense weights, norm scale 1 and bias 0. Draws come
    from ``generator`` (CPU) in module order."""
    def normal(w, std):
        w.copy_(torch.randn(w.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, nn.ConvTranspose3d):
            normal(m.weight, math.sqrt(2.0 / (m.weight.shape[0] * m.weight[0, 0].numel())))
        elif isinstance(m, (nn.Conv2d, nn.Conv3d)):
            normal(m.weight, math.sqrt(2.0 / m.weight[0].numel()))
        elif isinstance(m, nn.Linear):
            normal(m.weight, 0.01)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()


def epix2vox_interface_input(b_input, n_views, out_hw=224):
    """Slice one-hots (B, V*C, S, S) -> EPix2Vox views (B, V, 3, 224, 224): the
    per-view foreground sum, resized bilinearly (half-pixel centers, antialiased
    where it shrinks, as ``jax.image.resize`` is), replicated to 3 channels, x255."""
    B, VC, S, S2 = b_input.shape
    C = VC // n_views
    fg = b_input.reshape(B, n_views, C, S, S2)[:, :, 1:].sum(dim=2)  # (B, V, S, S)
    fg = F.interpolate(fg, size=(out_hw, out_hw), mode='bilinear', align_corners=False,
                       antialias=max(S, S2) > out_hw)
    return fg[:, :, None].expand(B, n_views, 3, out_hw, out_hw) * 255.0


def epix2vox_interface_output(volume):
    """(B, S, S, S) occupancy -> (B, 2, S, S, S) background/foreground stack."""
    return torch.stack([1.0 - volume, volume], dim=1)
