"""Plain (E)Pix2Vox at 128^3 (the 'hybrid-EPix2Vox' model type), float32.

Views (B, V, 3, 224, 224) -> occupancy (B, 128, 128, 128). Encoder: conv1..layer2
of ResNet50 (7x7/2 conv, 3x3/2 max pool, 3 + 4 bottlenecks, TF 'SAME' padding in
the strided 3x3), then 3x3, 3x3 (ELU), 3x3/3 max pool, 1x1 (ELU); the (B*V, 256,
8, 8) features are laid out channels-last as (B, V, 8, 8, 256) and a 3^3 conv
with the views as channels fuses them (LeakyReLU 0.2). Decoder: the features read
as (B*V, 2, 2, 2, 2048) channels-last, six 4^3 stride-2 transposed convs (512, 128,
32, 32, 32, 8), a 1^3 head and a sigmoid. Merger: 3^3 convs 9 -> 16 -> 8 -> 4 -> 2
-> 1 with LeakyReLU 0.2, a softmax over the views, the weighted sum of the coarse
volumes clipped to [0, 1]. Every norm is a batch norm on the batch's statistics
(biased variance, eps 1e-5). The interface: each view's foreground (the sum of
its non-background channels), resized bilinearly to 224^2, x255, three channels;
occupancy v out as the stack (1 - v, v). Parameter names are the training step's.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class BN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        dims = [0] + list(range(2, x.ndim))
        var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight.view(shape) \
            + self.bias.view(shape)


class W(nn.Module):
    """A weight (and an optional bias) whose arithmetic comes from the caller."""

    def __init__(self, shape, bias=False, transposed=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))
        if bias:
            self.bias = nn.Parameter(torch.zeros(shape[1] if transposed else shape[0]))
        else:
            self.bias = None


def _same_pad(x, k, stride):
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Bottleneck(nn.Module):
    def __init__(self, ci, f, stride=1):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = W((f, ci, 1, 1)), BN(f)
        self.conv2, self.bn2 = W((f, f, 3, 3)), BN(f)
        self.conv3, self.bn3 = W((4 * f, f, 1, 1)), BN(4 * f)
        if ci != 4 * f or stride != 1:
            self.down, self.bn_down = W((4 * f, ci, 1, 1)), BN(4 * f)

    def forward(self, x, p):
        out = F.relu(self.bn1(p.conv2d(x, self.conv1.weight)))
        out = F.relu(self.bn2(p.conv2d(_same_pad(out, 3, self.stride), self.conv2.weight,
                                       stride=self.stride)))
        out = self.bn3(p.conv2d(out, self.conv3.weight))
        res = x
        if hasattr(self, 'down'):
            res = self.bn_down(p.conv2d(x, self.down.weight, stride=self.stride))
        return F.relu(out + res)


class ResNetStem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = W((64, 3, 7, 7)), BN(64)
        for i in range(3):
            self.add_module(f'l1_b{i}', Bottleneck(64 if i == 0 else 256, 64))
        for i in range(4):
            self.add_module(f'l2_b{i}', Bottleneck(256 if i == 0 else 512, 128,
                                                   2 if i == 0 else 1))

    def forward(self, x, p):
        x = F.relu(self.bn1(p.conv2d(x, self.conv1.weight, stride=2, padding=3)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(3):
            x = getattr(self, f'l1_b{i}')(x, p)
        for i in range(4):
            x = getattr(self, f'l2_b{i}')(x, p)
        return x


class Encoder(nn.Module):
    def __init__(self, V):
        super().__init__()
        self.resnet = ResNetStem()
        self.l1_conv, self.l1_bn = W((512, 512, 3, 3), bias=True), BN(512)
        self.l2_conv, self.l2_bn = W((512, 512, 3, 3), bias=True), BN(512)
        self.l3_conv, self.l3_bn = W((256, 512, 1, 1), bias=True), BN(256)
        self.l4_conv, self.l4_bn = W((1, V, 3, 3, 3), bias=True), BN(1)

    def forward(self, views, p):
        B, V = views.shape[:2]
        x = self.resnet(views.reshape((B * V,) + tuple(views.shape[2:])), p)
        x = F.elu(self.l1_bn(p.conv2d(x, self.l1_conv.weight, self.l1_conv.bias)))
        x = F.elu(self.l2_bn(p.conv2d(x, self.l2_conv.weight, self.l2_conv.bias)))
        x = F.max_pool2d(x, 3, stride=3)
        x = F.elu(self.l3_bn(p.conv2d(x, self.l3_conv.weight, self.l3_conv.bias)))
        x = x.permute(0, 2, 3, 1).reshape(B, V, 8, 8, 256)
        x = p.conv3d(x, self.l4_conv.weight, self.l4_conv.bias, padding=1)
        return F.leaky_relu(self.l4_bn(x), 0.2)


class Decoder(nn.Module):
    FEATURES = (512, 128, 32, 32, 32, 8)

    def __init__(self):
        super().__init__()
        ci = 2048
        for i, f in enumerate(self.FEATURES):
            self.add_module(f'up{i}', W((ci, f, 4, 4, 4), transposed=True))
            self.add_module(f'up{i}_bn', BN(f))
            ci = f
        self.head = W((ci, 1, 1, 1, 1), transposed=True)

    def forward(self, feats, p):
        B, V = feats.shape[:2]
        x = feats.reshape(B * V, 2, 2, 2, 2048).permute(0, 4, 1, 2, 3)
        for i in range(len(self.FEATURES)):
            up = getattr(self, f'up{i}')
            x = F.relu(getattr(self, f'up{i}_bn')(
                p.conv_transpose3d(x, up.weight, stride=2, padding=1)))
        vol = torch.sigmoid(p.conv_transpose3d(x, self.head.weight))
        raw = torch.cat([x, vol], dim=1)
        S = raw.shape[-1]
        return raw.reshape(B, V, -1, S, S, S), vol.reshape(B, V, S, S, S)


class Merger(nn.Module):
    FEATURES = (16, 8, 4, 2, 1)

    def __init__(self):
        super().__init__()
        ci = 9
        for i, f in enumerate(self.FEATURES):
            self.add_module(f'm{i}_conv', W((f, ci, 3, 3, 3), bias=True))
            self.add_module(f'm{i}_bn', BN(f))
            ci = f

    def forward(self, raw, coarse, p):
        B, V = raw.shape[:2]
        x = raw.reshape((B * V,) + tuple(raw.shape[2:]))
        for i in range(len(self.FEATURES)):
            c = getattr(self, f'm{i}_conv')
            x = F.leaky_relu(getattr(self, f'm{i}_bn')(p.conv3d(x, c.weight, c.bias, padding=1)),
                             0.2)
        S = x.shape[-1]
        weights = torch.softmax(x.reshape(B, V, S, S, S), dim=1)
        return torch.clamp((coarse * weights).sum(dim=1), 0.0, 1.0)


class Model(nn.Module):
    def __init__(self, spec):
        super().__init__()
        if spec['model_type'] != 'hybrid-EPix2Vox':
            raise ValueError(f"this reference is EPix2Vox's, not {spec['model_type']!r}")
        self.n_views = spec['n_views']
        self.encoder = Encoder(self.n_views)
        self.decoder = Decoder()
        self.merger = Merger()

    def forward(self, views, p):
        raw, coarse = self.decoder(self.encoder(views, p), p)
        return self.merger(raw, coarse, p)


def init_kinds(model):
    """Kaiming normal (std sqrt(2 / fan_in)) on conv and transposed-conv weights,
    zero biases, unit norm scales."""
    kinds = {}
    for name, p in model.named_parameters():
        if name.endswith('bias'):
            kinds[name] = ('zeros', 0.0)
        elif p.dim() == 1:
            kinds[name] = ('ones', 0.0)
        elif '.up' in name or name.startswith('decoder.head'):
            kinds[name] = ('normal', math.sqrt(2.0 / (p.shape[0] * p[0, 0].numel())))
        else:
            kinds[name] = ('normal', math.sqrt(2.0 / p[0].numel()))
    return kinds


def logits(model, b_input, grid_affines, spec, prec):
    """The interface around the model: slices (B, V*C, S, S) -> (B, 2, S^3)."""
    B, VC, S, _ = b_input.shape
    V = model.n_views
    fg = b_input.reshape(B, V, VC // V, S, S)[:, :, 1:].sum(dim=2)
    if S > 224:
        raise ValueError("the reference enlarges the views only")
    fg = F.interpolate(fg, size=(224, 224), mode='bilinear', align_corners=False)
    views = fg[:, :, None].expand(B, V, 3, 224, 224) * 255.0
    occ = model(views, prec)
    return torch.stack([1.0 - occ, occ], dim=1)


def optimizer_groups(model, spec, lr):
    """Adam without weight decay: the merger at 1e-4, everything else at 1e-3."""
    named = list(model.named_parameters())
    return [dict(params=[(n, p) for n, p in named if not n.startswith('merger.')],
                 lr=1e-3, weight_decay=0.0, decoupled=False),
            dict(params=[(n, p) for n, p in named if n.startswith('merger.')],
                 lr=1e-4, weight_decay=0.0, decoupled=False)]
