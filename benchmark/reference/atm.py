"""Plain affine transform module: a localization CNN over one view's prescan and
the heads that turn its output into the view's learned affine theta.

Localization net: eight 5^3 convs (width w: w, 2w x5, w x2), each followed by a
parameter-free instance norm and LeakyReLU 0.01 (slope 1 at 0), 2x average
pooling after convs 1, 3, 5 and 7, a 1^3 conv to one channel and its instance
norm, then a dense layer over the (P/16)^3 voxels. Heads (R6-vector method):
theta = translation @ rotation @ zoom, the rotation from six outputs plus
(0.01, 0, 0, 0, 0.01, 0), the translation a soft-argmax over 3 x ``vox_range``
outputs, the zoom 1 - zoom_clip * tanh(last output + 1).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.geometry import compose, rotation_from_r6

_INIT_R6 = (1e-2, 0.0, 0.0, 0.0, 1e-2, 0.0)


def leaky_relu(x, slope=0.01):
    return torch.where(x >= 0, x, x * slope)


def instance_norm(x, eps=1e-5):
    var, mean = torch.var_mean(x, dim=tuple(range(2, x.ndim)), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def vox_range(offset_clip, spat):
    lo = ((-offset_clip + 1.0) * spat - 1.0) / 2.0
    hi = ((offset_clip + 1.0) * spat - 1.0) / 2.0
    return int(round(hi - lo))


class ConvNet(nn.Module):
    PLAN = (1, 2, 2, 2, 2, 2, 1, 1)

    def __init__(self, ci, width):
        super().__init__()
        convs = []
        for m in self.PLAN:
            convs.append(nn.Conv3d(ci, m * width, 5, padding=2))
            ci = m * width
        self.convs = nn.ModuleList(convs)
        self.conv8 = nn.Conv3d(ci, 1, 1)


class LocalizationNet(nn.Module):
    def __init__(self, ci, spat, n_out, width):
        super().__init__()
        self.convnet = ConvNet(ci, width)
        self.dense = nn.Linear((spat // 16) ** 3, n_out)


class AffineTransformModule(nn.Module):
    """One view's module; parameter names as the training step's."""

    def __init__(self, ci, spat, offset_clip, zoom_clip, width):
        super().__init__()
        self.spat, self.offset_clip, self.zoom_clip = spat, offset_clip, zoom_clip
        self.locnet = LocalizationNet(ci, spat, 6 + 3 * vox_range(offset_clip, spat) + 1,
                                      width)

    def forward(self, prescan, prec):
        cn = self.locnet.convnet

        def block(x, i):
            c = cn.convs[i]
            return leaky_relu(instance_norm(prec.conv3d(x, c.weight, c.bias, padding=2)))

        x = F.avg_pool3d(block(prescan, 0), 2)
        x = F.avg_pool3d(block(block(x, 1), 2), 2)
        x = F.avg_pool3d(block(block(x, 3), 4), 2)
        x = F.avg_pool3d(block(block(x, 5), 6), 2)
        x = block(x, 7)
        x = instance_norm(prec.conv3d(x, cn.conv8.weight, cn.conv8.bias))
        head = prec.linear(x.flatten(1), self.locnet.dense.weight, self.locnet.dense.bias)
        return self.theta(head)

    def theta(self, head):
        B, n = head.shape[0], vox_range(self.offset_clip, self.spat)
        rot = rotation_from_r6(head[:, :6] + head.new_tensor(_INIT_R6))
        pos = torch.arange(n, dtype=head.dtype, device=head.device) + (self.spat - n) // 2
        soft = (torch.softmax(head[:, 6:-1].reshape(B, 3, n), dim=2) * pos).sum(-1)
        offsets = (2.0 * soft + 1.0) / self.spat - 1.0
        if self.offset_clip == 0.0:
            offsets = 0.0 * offsets
        eye = torch.eye(4, dtype=head.dtype, device=head.device)
        trans = torch.cat([torch.cat([eye[:3, :3].expand(B, 3, 3), offsets[..., None]], -1),
                           eye[3:].expand(B, 1, 4)], dim=1)
        zoom = self.zoom_clip * -torch.tanh(head[:, -1:] + 1.0) + 1.0
        scale = torch.diag_embed(torch.cat([zoom.expand(B, 3), torch.ones_like(zoom)], -1))
        return compose(trans, rot, scale)


def lecun_std(fan_in):
    """The step's init: a normal truncated at +-2 std, std sqrt(1 / fan_in) / 0.8796."""
    return math.sqrt(1.0 / fan_in) / 0.87962566103423978


def init_kinds(module):
    """{parameter name: (kind, std)} of the lecun-normal initialization (convs,
    transposed convs, dense layers), zero biases and unit norm scales."""
    kinds = {}
    for prefix, m in module.named_modules():
        p = prefix + '.' if prefix else ''
        w = getattr(m, 'weight', None)
        if not isinstance(w, torch.Tensor):
            continue
        if isinstance(m, nn.ConvTranspose3d):
            kinds[p + 'weight'] = ('trunc_normal', lecun_std(w.shape[0] * w[0, 0].numel()))
        elif w.dim() > 1:
            kinds[p + 'weight'] = ('trunc_normal', lecun_std(w[0].numel()))
        else:
            kinds[p + 'weight'] = ('ones', 0.0)
        if getattr(m, 'bias', None) is not None:
            kinds[p + 'bias'] = ('zeros', 0.0)
    return kinds
