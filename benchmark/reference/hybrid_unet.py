"""Plain hybrid 2D/3D U-Net (the 'hybrid-unet' model type), float32.

(B, V*C, S, S) view slices + (V, B, 4, 4) slice affines -> (B, C, S, S, S)
logits. Encoder: per level two 3x3 convs grouped by view (the first of stride 2
from level 1 on, with TF 'SAME' padding), each with an affine instance norm and
LeakyReLU 0.01. Each level's features are re-embedded into 3D along each view's
inverted, zoom-stripped slice affine (``embed_plane``). Decoder, deepest first:
a 2^3 stride-2 transposed conv, the concat [upsampled, re-embedded skip], two 3^3
convs with norm and activation. A 1^3 head. Parameter names are the training
step's, so one set of weights loads into both.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import atm as atm_ref
from benchmark.reference.geometry import affine_zooms, embed_plane, scale_columns


class Norm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = atm_ref.instance_norm(x) * self.weight.view(shape) + self.bias.view(shape)
        return atm_ref.leaky_relu(y)


class Conv(nn.Module):
    """Weight and bias of a conv; the arithmetic comes from the caller."""

    def __init__(self, shape, transposed=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(shape[1] if transposed else shape[0]))


class EncoderStage(nn.Module):
    def __init__(self, ci, co, stride, groups):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.a_conv = Conv((co, ci // groups, 3, 3))
        self.a_norm = Norm(co)
        self.b_conv = Conv((co, co // groups, 3, 3))
        self.b_norm = Norm(co)

    def forward(self, x, prec):
        pads = []
        for n in (x.shape[-1], x.shape[-2]):
            total = max((-(-n // self.stride) - 1) * self.stride + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        x = self.a_norm(prec.conv2d(F.pad(x, pads), self.a_conv.weight, self.a_conv.bias,
                                    stride=self.stride, groups=self.groups))
        return self.b_norm(prec.conv2d(x, self.b_conv.weight, self.b_conv.bias, padding=1,
                                       groups=self.groups))


class DecoderStage(nn.Module):
    def __init__(self, ci, co):
        super().__init__()
        self.up = Conv((ci, co, 2, 2, 2), transposed=True)
        self.a_conv = Conv((co, 2 * co, 3, 3, 3))
        self.a_norm = Norm(co)
        self.b_conv = Conv((co, co, 3, 3, 3))
        self.b_norm = Norm(co)

    def forward(self, y, skip, prec):
        y = torch.cat([prec.conv_transpose3d(y, self.up.weight, self.up.bias, stride=2), skip],
                      dim=1)
        y = self.a_norm(prec.conv3d(y, self.a_conv.weight, self.a_conv.bias, padding=1))
        return self.b_norm(prec.conv3d(y, self.b_conv.weight, self.b_conv.bias, padding=1))


class Model(nn.Module):
    def __init__(self, spec):
        super().__init__()
        V, C = spec['n_views'], spec['num_classes']
        feats = [V * f for f in spec['base_features']]
        ins = [V * C] + feats[:-1]
        self.n_views = V
        self.encoder = nn.ModuleList([EncoderStage(ci, co, 1 if s == 0 else 2, V)
                                      for s, (ci, co) in enumerate(zip(ins, feats))])
        self.decoder = nn.ModuleList([DecoderStage(feats[s + 1], feats[s])
                                      for s in range(len(feats) - 1)])
        self.seg_head = Conv((C, feats[0], 1, 1, 1))

    def skip(self, x, inv_aff):
        """Each view's channels of (B, V*F, S, S) re-embedded -> (B, V*F, S, S, S)."""
        F_ = x.shape[1] // self.n_views
        return torch.cat([embed_plane(x[:, v * F_:(v + 1) * F_], inv_aff[v], x.shape[-1])
                          for v in range(self.n_views)], dim=1)

    def forward(self, x, grid_affines, prec):
        inv_aff = torch.linalg.inv(scale_columns(grid_affines, 1.0 / affine_zooms(grid_affines)))
        skips = []
        for stage in self.encoder:
            x = stage(x, prec)
            skips.append(x)
        y = self.skip(skips[-1], inv_aff)
        for s in range(len(self.decoder) - 1, -1, -1):
            y = self.decoder[s](y, self.skip(skips[s], inv_aff), prec)
        return prec.conv3d(y, self.seg_head.weight, self.seg_head.bias)


def init_kinds(model):
    kinds = {}
    for name, p in model.named_parameters():
        if name.endswith('bias'):
            kinds[name] = ('zeros', 0.0)
        elif p.dim() == 1:
            kinds[name] = ('ones', 0.0)
        elif '.up.' in name:
            kinds[name] = ('trunc_normal', atm_ref.lecun_std(p.shape[0] * p[0, 0].numel()))
        else:
            kinds[name] = ('trunc_normal', atm_ref.lecun_std(p[0].numel()))
    return kinds


def logits(model, b_input, grid_affines, spec, prec):
    return model(b_input, grid_affines, prec)


def optimizer_groups(model, spec, lr):
    """AdamW, lr, weight decay 0.01, over every parameter."""
    return [dict(params=list(model.named_parameters()), lr=lr, weight_decay=0.01)]
