"""Hybrid 2D-encoder / 3D-decoder U-Net for multi-slice -> volume reconstruction
(torch port of ``acquisition_focus_tpu/models/hybrid_unet.py``).

(B, n_views*num_classes, S, S) slices + (n_views, B, 4, 4) slice affines ->
(B, num_classes, S, S, S) logits. Grouped 2D encoder (groups = n_views), two conv
blocks per stage, InstanceNorm(affine) + LeakyReLU, stride-2 downsampling from stage 1
on; skip connectors re-embed every 2D feature map into 3D along the inverted,
zoom-stripped slice affine (kernel K1 on CUDA, all views in one launch); 3D decoder
with 2^3/2 transposed-conv upsampling, skip concat (each stage re-embeds its own
level's skip, on CUDA straight into the concat buffer), two 3^3 conv blocks per
stage (at the full-resolution level on CUDA: kernel K3 forward, and per
``use_pallas_conv`` K3 as the input gradient and K4 as the weight gradient); 1x1x1
head in float32.

The convs compute in ``dtype`` (bf16 under autocast over float32 params); norms
compute in float32, as flax's GroupNorm does with float32 params.
"""

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from acquisition_focus_tpu_torch.models import recompute
from acquisition_focus_tpu_torch.models.localization import compute_autocast, leaky_relu
from acquisition_focus_tpu_torch.ops.affine import affine_zooms, scale_affine_columns
from acquisition_focus_tpu_torch.ops.kernels.conv3d import conv3d, supports_conv3d
from acquisition_focus_tpu_torch.ops.kernels.plane_resample import skip_concat

BASE_FEATURES = (16, 32, 64, 128, 256, 256)


def _compute_dtype(x):
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def _norm_act(norm, x):
    """InstanceNorm(affine) in float32 + LeakyReLU 0.01. Over a single voxel (the
    deepest level of six at 32^3) the normalized value is 0 and the output the
    bias, as flax's GroupNorm gives it; torch's instance norm refuses that size."""
    x = x.float()
    if x[0, 0].numel() == 1:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return leaky_relu((x - x) * norm.weight.view(shape) + norm.bias.view(shape))
    return leaky_relu(norm(x))


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
        return recompute.conv(x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=1)


class SkipConnector(nn.Module):
    """(B, n_views*f, S, S) features + (n_views, B, 4, 4) slice affines ->
    (B, n_views*f, S, S, S): each view's features re-embedded along its slice;
    given ``y`` (B, co, S, S, S), ``torch.cat([y, that], 1)`` (one buffer on CUDA)."""

    def __init__(self, n_views):
        super().__init__()
        self.n_views = n_views

    def forward(self, x, grid_affines, y=None):
        with torch.autocast(x.device.type, enabled=False):
            g = grid_affines.float()
            # inv_ex: linalg.inv's singularity check reads a flag back from the
            # card, waiting for all queued work (these are rotations and zooms)
            inv_aff = torch.linalg.inv_ex(
                scale_affine_columns(g, 1.0 / affine_zooms(g))).inverse
        return skip_concat(y, x.to(_compute_dtype(x)), inv_aff)


class DecoderStage(nn.Module):
    """Upsample, concat the skip re-embedded into 3D, two 3^3 conv blocks;
    ``keep_conv_in``: the convs keep their inputs for the weight gradient inside a
    recompute region (the JAX package's ``'conv_in{level}'`` names)."""

    def __init__(self, ci, co, use_kernel=False, keep_conv_in=False):
        super().__init__()
        self.keep_conv_in = keep_conv_in
        self.up = nn.ConvTranspose3d(ci, co, 2, stride=2)
        self.a_conv = Conv3x3x3(2 * co, co, use_kernel)
        self.a_norm = nn.InstanceNorm3d(co, eps=1e-5, affine=True)
        self.b_conv = Conv3x3x3(co, co, use_kernel)
        self.b_norm = nn.InstanceNorm3d(co, eps=1e-5, affine=True)

    def forward(self, y, embed_skip):
        """``embed_skip(y_up)``: ``torch.cat([y_up, this level's skip in 3D], 1)``."""
        y = embed_skip(recompute.conv_module(self.up, y))
        with recompute.keep_residuals(self.keep_conv_in):
            y = self.a_conv(y)
        y = _norm_act(self.a_norm, y)
        with recompute.keep_residuals(self.keep_conv_in):
            y = self.b_conv(y)
        return _norm_act(self.b_norm, y)


def decoder_save_levels(decoder_save_names, n_levels):
    """The JAX package's ``decoder_save_names`` check: a subset of 'conv_out',
    'conv_in' (every level) and 'conv_in{level}'; raises ValueError otherwise.
    Returns the levels whose conv inputs are kept."""
    valid = {'conv_out', 'conv_in'} | {f'conv_in{s}' for s in range(n_levels)}
    unknown = set(decoder_save_names) - valid
    if unknown:
        raise ValueError(f"unknown decoder_save_names {sorted(unknown)}: expected "
                         f"a subset of {sorted(valid)}")
    return {s for s in range(n_levels)
            if 'conv_in' in decoder_save_names or f'conv_in{s}' in decoder_save_names}


class HybridUnet(nn.Module):
    """Recompute as the JAX module's: every decoder stage is a recompute region
    (``models/recompute.py``). ``remat_skips``: the stages and the deepest skip
    re-embedding run again whole in backward; otherwise the stages keep their
    convolutions' outputs (if ``'conv_out'`` is in ``decoder_save_names``), K1f's
    concat buffer, the forward all-gathers of a feature-sharded stage
    (``parallel/feature_parallel.py``) and the conv inputs of the named levels,
    and recompute the norms, activations and concats."""

    def __init__(self, n_views, num_classes, base_features=BASE_FEATURES,
                 dtype=torch.float32, use_pallas_conv=False, remat_skips=True,
                 decoder_save_names=('conv_out',)):
        super().__init__()
        self.dtype = dtype
        self.remat_skips = remat_skips
        feats = [n_views * f for f in base_features]
        ins = [n_views * num_classes] + feats[:-1]
        keep_in = set() if remat_skips else decoder_save_levels(decoder_save_names,
                                                                len(feats) - 1)
        self.save_ops = None if remat_skips else recompute.SKIP | recompute.COLLECTIVES | (
            recompute.CONV_OUT if 'conv_out' in decoder_save_names else frozenset())
        self.encoder = nn.ModuleList([
            EncoderStage(ci, co, 1 if s == 0 else 2, n_views)
            for s, (ci, co) in enumerate(zip(ins, feats))])
        self.skip_connector = SkipConnector(n_views)
        self.decoder = nn.ModuleList([
            DecoderStage(feats[s + 1], feats[s], use_pallas_conv, s in keep_in)
            for s in range(len(feats) - 1)])
        self.seg_head = nn.Conv3d(feats[0], num_classes, 1)

    def forward(self, x, grid_affines):
        with compute_autocast(x.device.type, self.dtype):
            skips = []
            for stage in self.encoder:
                x = stage(x)
                skips.append(x)
            # each level's skip is re-embedded where the decoder takes it, so the
            # six 3D skip volumes never live side by side
            if self.remat_skips:
                y = recompute.region(self.skip_connector, skips[-1], grid_affines)
            else:
                y = self.skip_connector(skips[-1], grid_affines)
            for s in range(len(self.decoder) - 1, -1, -1):
                y = recompute.region(
                    self.decoder[s], y,
                    functools.partial(self.skip_connector, skips[s], grid_affines),
                    save_ops=self.save_ops)
        return self.seg_head(y.float())
