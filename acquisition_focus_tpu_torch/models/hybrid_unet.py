"""Hybrid 2D-encoder / 3D-decoder U-Net for multi-slice -> volume reconstruction
(torch port of ``acquisition_focus_tpu/models/hybrid_unet.py``).

(B, n_views*num_classes, S, S) slices + (n_views, B, 4, 4) slice affines ->
(B, num_classes, S, S, S) logits. Grouped 2D encoder (groups = n_views), two conv
blocks per stage, InstanceNorm(affine) + LeakyReLU, stride-2 downsampling from stage 1
on; skip connectors re-embed every 2D feature map into 3D along the inverted,
zoom-stripped slice affine (kernel K1 on CUDA); 3D decoder with 2^3/2 transposed-conv
upsampling, skip concat, two 3^3 conv blocks per stage (at the full-resolution
level on CUDA: kernel K3 forward, and per ``use_pallas_conv`` K3 as the input
gradient and K4 as the weight gradient); 1x1x1 head in float32.

The convs compute in ``dtype`` (bf16 under autocast over float32 params); norms
compute in float32, as flax's GroupNorm does with float32 params.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from acquisition_focus_tpu_torch.models.localization import compute_autocast, leaky_relu
from acquisition_focus_tpu_torch.ops.affine import affine_zooms, scale_affine_columns
from acquisition_focus_tpu_torch.ops.kernels.conv3d import conv3d, supports_conv3d
from acquisition_focus_tpu_torch.ops.kernels.plane_resample import plane_resample

BASE_FEATURES = (16, 32, 64, 128, 256, 256)


def _compute_dtype(x):
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def _norm_act(norm, x):
    """InstanceNorm(affine) in float32 + LeakyReLU 0.01."""
    return leaky_relu(norm(x.float()))


def _same_pad_2d(x, stride):
    """flax/TF 'SAME' padding of a 3x3 conv: for stride 2 it pads
    (total // 2, total - total // 2), which differs from torch's symmetric pad."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class EncoderStage(nn.Module):
    def __init__(self, ci, co, stride, groups):
        super().__init__()
        self.stride = stride
        self.a_conv = nn.Conv2d(ci, co, 3, stride=stride, groups=groups)
        self.a_norm = nn.InstanceNorm2d(co, eps=1e-5, affine=True)
        self.b_conv = nn.Conv2d(co, co, 3, padding=1, groups=groups)
        self.b_norm = nn.InstanceNorm2d(co, eps=1e-5, affine=True)

    def forward(self, x):
        x = _norm_act(self.a_norm, self.a_conv(_same_pad_2d(x, self.stride)))
        return _norm_act(self.b_norm, self.b_conv(x))


class Conv3x3x3(nn.Module):
    """3^3 SAME conv routed as the JAX package's ``Conv3x3x3`` routes it
    (``use_kernel`` = its ``use_pallas``; ``mode`` holds the resolved mode), where
    the shape qualifies (the full-resolution decoder level); every other level is
    ``F.conv3d``:

      False          F.conv3d, library gradients
      True / 'fwd'   K3 forward, library gradients
      'fwdN'         'fwd' when the input has at least N channels, else False
      'wg'           K3 forward, K4 weight gradient, library input gradient
      'dx'           K3 forward, K3 input gradient, library weight gradient
      'full'         K3 forward, K3 input gradient, K4 weight gradient
    """

    MODES = (False, True, 'fwd', 'wg', 'dx', 'full')

    def __init__(self, ci, co, use_kernel=False):
        super().__init__()
        mode = use_kernel
        if isinstance(mode, str) and mode[:3] == 'fwd' and mode[3:].isdigit():
            mode = 'fwd' if ci >= int(mode[3:]) else False
        if mode not in self.MODES:
            raise ValueError(
                f"unknown use_pallas_conv3d mode {use_kernel!r}: expected one of "
                "False, True, 'fwd', 'fwdN' (N = min channel count), 'wg', 'dx', 'full'")
        self.mode = mode
        self.weight = nn.Parameter(torch.empty(co, ci, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(co))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        x = x.to(_compute_dtype(x))
        if self.mode and supports_conv3d(x.shape, self.weight.shape):
            return conv3d(x, self.weight, self.bias, kernel_dx=self.mode in ('dx', 'full'),
                          kernel_dw=self.mode in ('wg', 'full'))
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=1)


class SkipConnector(nn.Module):
    """(B, n_views*f, S, S) features + (n_views, B, 4, 4) slice affines ->
    (B, n_views*f, S, S, S): each view's features re-embedded along its slice."""

    def __init__(self, n_views):
        super().__init__()
        self.n_views = n_views

    def forward(self, x, grid_affines):
        S = x.shape[-1]
        f = x.shape[1] // self.n_views
        with torch.autocast(x.device.type, enabled=False):
            g = grid_affines.float()
            inv_aff = torch.linalg.inv(scale_affine_columns(g, 1.0 / affine_zooms(g)))
        x = x.to(_compute_dtype(x))
        return torch.cat([plane_resample(x[:, v * f:(v + 1) * f], inv_aff[v], S)
                          for v in range(self.n_views)], dim=1)


class DecoderStage(nn.Module):
    """Upsample, concat the skip, two 3^3 conv blocks."""

    def __init__(self, ci, co, use_kernel=False):
        super().__init__()
        self.up = nn.ConvTranspose3d(ci, co, 2, stride=2)
        self.a_conv = Conv3x3x3(2 * co, co, use_kernel)
        self.a_norm = nn.InstanceNorm3d(co, eps=1e-5, affine=True)
        self.b_conv = Conv3x3x3(co, co, use_kernel)
        self.b_norm = nn.InstanceNorm3d(co, eps=1e-5, affine=True)

    def forward(self, y, skip):
        y = self.up(y)
        y = torch.cat([y, skip.to(y.dtype)], dim=1)
        y = _norm_act(self.a_norm, self.a_conv(y))
        return _norm_act(self.b_norm, self.b_conv(y))


class HybridUnet(nn.Module):
    def __init__(self, n_views, num_classes, base_features=BASE_FEATURES,
                 dtype=torch.float32, use_pallas_conv=False):
        super().__init__()
        self.dtype = dtype
        feats = [n_views * f for f in base_features]
        ins = [n_views * num_classes] + feats[:-1]
        self.encoder = nn.ModuleList([
            EncoderStage(ci, co, 1 if s == 0 else 2, n_views)
            for s, (ci, co) in enumerate(zip(ins, feats))])
        self.skip_connector = SkipConnector(n_views)
        self.decoder = nn.ModuleList([
            DecoderStage(feats[s + 1], feats[s], use_pallas_conv)
            for s in range(len(feats) - 1)])
        self.seg_head = nn.Conv3d(feats[0], num_classes, 1)

    def forward(self, x, grid_affines):
        with compute_autocast(x.device.type, self.dtype):
            skips = []
            for stage in self.encoder:
                x = stage(x)
                skips.append(x)
            skips3d = [self.skip_connector(s, grid_affines) for s in skips]
            y = skips3d[-1]
            for s in range(len(self.decoder) - 1, -1, -1):
                y = self.decoder[s](y, skips3d[s])
        return self.seg_head(y.float())
