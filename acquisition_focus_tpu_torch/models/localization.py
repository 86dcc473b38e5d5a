"""Localization CNN predicting view-affine parameters from a prescan volume
(torch port of ``acquisition_focus_tpu/models/localization.py``).

5x5x5 convs, parameter-free instance norm, LeakyReLU 0.01, 2x average pooling, a
1x1x1 collapse to one channel, then a dense head. The JAX package runs the 128^3 and
64^3 stages in space-to-depth form, an exact rewrite that only serves the TPU's
matrix unit; here every conv is the plain ``Conv3d`` with the same parameters.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from acquisition_focus_tpu_torch.models import recompute


def leaky_relu(x, negative_slope=0.01):
    """LeakyReLU with flax's convention at 0 (slope 1 there, where
    ``F.leaky_relu`` takes ``negative_slope``)."""
    return torch.where(x >= 0, x, x * negative_slope)


def instance_norm_stateless(x, eps=1e-5):
    """Parameter-free instance norm over the spatial axes of (B, C, ...), computed
    in float32 and returned in ``x.dtype``."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=tuple(range(2, x.ndim)), keepdim=True,
                               correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class ConvNet(nn.Module):
    """Backbone: (B, C, D, H, W) -> (B, 1, D/16, H/16, W/16). ``width`` scales the
    channel plan (reference plan = width 32: 32, 64 x5, 32 x2, 1)."""

    PLAN = ('w1', 'w2', 'w2', 'w2', 'w2', 'w2', 'w1', 'w1')

    def __init__(self, in_channels, width=32):
        super().__init__()
        sizes = {'w1': width, 'w2': 2 * width}
        convs, ci = [], in_channels
        for key in self.PLAN:
            convs.append(nn.Conv3d(ci, sizes[key], 5, padding=2))
            ci = sizes[key]
        self.convs = nn.ModuleList(convs)
        self.conv8 = nn.Conv3d(ci, 1, 1)

    def forward(self, x):
        def block(x, i):
            x = instance_norm_stateless(recompute.conv_module(self.convs[i], x))
            return leaky_relu(x)

        x = F.avg_pool3d(block(x, 0), 2)
        x = F.avg_pool3d(block(block(x, 1), 2), 2)
        x = F.avg_pool3d(block(block(x, 3), 4), 2)
        x = F.avg_pool3d(block(block(x, 5), 6), 2)
        x = block(x, 7)
        return instance_norm_stateless(recompute.conv_module(self.conv8, x))


def compute_autocast(device_type, dtype):
    """Autocast to the compute dtype (bf16 convs over float32 params); a no-op
    context for float32."""
    return torch.autocast(device_type, dtype=dtype, enabled=dtype != torch.float32)


class LocalizationNet(nn.Module):
    """ConvNet backbone in the compute dtype + float32 dense head."""

    def __init__(self, in_channels, spat, output_size, width=32, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convnet = ConvNet(in_channels, width)
        self.dense = nn.Linear((spat // 16) ** 3, output_size)

    def forward(self, x):
        with compute_autocast(x.device.type, self.dtype):
            h = self.convnet(x).flatten(1)
        return self.dense(h.float())
