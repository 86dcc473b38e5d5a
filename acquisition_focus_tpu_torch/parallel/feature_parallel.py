"""Feature-sharded stand-ins for the reconstruction models' modules (the 'model'
axis): the hybrid U-Net's stages (:func:`shard_unet`) and (E)Pix2Vox's conv and
batch-norm pairs (:func:`shard_epix2vox`).

Each stand-in takes its slice from a full module: it adopts the module's own
parameter objects and narrows their data in place to this rank's contiguous
chunk of output features (so an optimizer built over the full module keeps
working on the slices), and computes that chunk from the replicated input:

* the encoder's grouped ``Conv2d`` (``groups = n_views``): a contiguous chunk of
  output channels can start or end inside a group (48 channels, 3 groups of 16,
  2 ranks: rank 0 holds group 0 and half of group 1). The chunk is computed one
  piece at a time -- the whole groups inside it as one grouped conv, each cut
  group as a plain conv on that group's input channels -- and the pieces are
  concatenated, which is the grouped conv's own math;
* ``InstanceNorm2d/3d(affine)`` on the slice: exact, the norm is per channel;
* ``Conv3x3x3`` on the slice (K3 and K4 at the 128^3 level, at Co / m);
* ``ConvTranspose3d``, whose output features are the weight's axis 1;
* the 1x1x1 ``seg_head`` (replicated where the class count does not divide).

Every stage takes its input through ``copy_to_model`` and hands its output on
gathered (``gather_from_model``), so the skip connectors (K1f/K1b) and the rest
of the model run unchanged on replicated tensors. A stage whose width the axis
does not divide stays the original module, replicated. Parameter names are the
full model's, so ``state_dict`` keys match; ``engine/checkpoint.py`` gathers the
slices back to full tensors.

(E)Pix2Vox keeps its forward code: each conv whose output channels the axis
splits becomes a stand-in that takes its input through ``copy_to_model`` and
computes this rank's chunk (:class:`ShardedConv`, :class:`ShardedConvTranspose3d`),
and the ``BatchNorm`` after it one that normalizes that chunk (its statistics
per channel, over the 'data' group only) and gathers it over 'model'
(:class:`ShardedBatchNorm`). So every tensor between the pairs is whole and
replicated: the activations, pooling, the Bottleneck's residual add, the
encoder's reshape to (B, V, 8, 8, 256), the decoder's concat and the modules
the rule leaves whole (``l4_conv``/``l4_bn``, the decoder's head, the merger's
2 -> 1 layer, and at m = 4 its 4 -> 2 layer) run unchanged.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from acquisition_focus_tpu_torch.models import recompute
from acquisition_focus_tpu_torch.models.epix2vox import BatchNorm, Bottleneck, EPix2VoxModel128
from acquisition_focus_tpu_torch.models.hybrid_unet import (
    DecoderStage, EncoderStage, _norm_act, _same_pad_2d)
from acquisition_focus_tpu_torch.parallel.collectives import (
    copy_to_model, gather_from_model)
from acquisition_focus_tpu_torch.parallel.mesh import SPLIT_ATTR

class _Shard:
    def __init__(self, mesh):
        self.index, self.count = mesh.axis_index('model'), mesh.axis_size('model')
        self.group = mesh.groups['model']

    def rows(self, n):
        """(first, count) of this rank's chunk of ``n`` features."""
        k = n // self.count
        return self.index * k, k


def _take(p, dim, shard):
    """Narrow parameter ``p`` in place to this rank's chunk along ``dim``."""
    lo, k = shard.rows(p.shape[dim])
    p.data = p.data.narrow(dim, lo, k).clone()
    setattr(p, SPLIT_ATTR, dim)
    return p


def _take_norm(norm, shard):
    _take(norm.weight, 0, shard)
    _take(norm.bias, 0, shard)
    norm.num_features = norm.weight.shape[0]
    return norm


def group_pieces(lo, hi, co_per_group, ci_per_group):
    """The output-channel chunk [lo, hi) of a grouped conv as pieces
    (r0, r1, i0, i1, groups): rows r0:r1 of the chunk from input channels i0:i1
    with ``groups`` groups. Whole groups inside the chunk form one piece; a cut
    group is a piece of its own (one group)."""
    pieces, g = [], lo // co_per_group
    while g * co_per_group < hi:
        o0, o1 = max(lo, g * co_per_group), min(hi, (g + 1) * co_per_group)
        whole = (o0, o1) == (g * co_per_group, (g + 1) * co_per_group)
        if whole and pieces and pieces[-1][5]:
            r0, _, i0, _, n, _ = pieces.pop()
            pieces.append((r0, o1 - lo, i0, (g + 1) * ci_per_group, n + 1, True))
        else:
            pieces.append((o0 - lo, o1 - lo, g * ci_per_group, (g + 1) * ci_per_group,
                           1, whole))
        g += 1
    return [p[:5] for p in pieces]


class ShardedGroupedConv2d(nn.Module):
    """This rank's output-channel chunk of a (grouped) ``nn.Conv2d``."""

    def __init__(self, conv, shard):
        super().__init__()
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        co, ci, groups = conv.out_channels, conv.in_channels, conv.groups
        lo, k = shard.rows(co)
        self.pieces = group_pieces(lo, lo + k, co // groups, ci // groups)
        self.weight = _take(conv.weight, 0, shard)
        self.bias = _take(conv.bias, 0, shard)

    def forward(self, x):
        outs = []
        for r0, r1, i0, i1, groups in self.pieces:
            whole = (r0, r1) == (0, self.weight.shape[0])
            w = self.weight if whole else self.weight[r0:r1]
            b = self.bias if whole else self.bias[r0:r1]
            xi = x if (i0, i1) == (0, x.shape[1]) else x[:, i0:i1]
            outs.append(F.conv2d(xi, w, b, self.stride, self.padding, self.dilation,
                                 groups))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _take_bias(module, conv, shard):
    if conv.bias is None:
        module.register_parameter('bias', None)
    else:
        module.bias = _take(conv.bias, 0, shard)


class ShardedConvTranspose3d(nn.Module):
    """This rank's output-feature chunk of an ``nn.ConvTranspose3d`` (weight axis
    1), its input taken through ``copy_to_model``."""

    def __init__(self, conv, shard):
        super().__init__()
        self.group = shard.group
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.weight = _take(conv.weight, 1, shard)
        _take_bias(self, conv, shard)

    def forward(self, x):
        return recompute.conv(copy_to_model(x, self.group), self.weight, self.bias,
                              self.stride, self.padding, self.dilation, True, 0, 1)


class ShardedConv(nn.Module):
    """This rank's output-channel chunk of an ungrouped ``nn.Conv2d`` or
    ``nn.Conv3d``, its input taken through ``copy_to_model``."""

    def __init__(self, conv, shard):
        super().__init__()
        assert conv.groups == 1 and conv.padding_mode == 'zeros'
        self.group = shard.group
        self.conv = F.conv2d if isinstance(conv, nn.Conv2d) else F.conv3d
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.weight = _take(conv.weight, 0, shard)
        _take_bias(self, conv, shard)

    def forward(self, x):
        return self.conv(copy_to_model(x, self.group), self.weight, self.bias,
                         self.stride, self.padding, self.dilation, 1)


class ShardedConv3d(ShardedConv):
    """:class:`ShardedConv` of an ``nn.Conv3d`` (the hybrid U-Net's 1x1x1 head), its
    output gathered."""

    def forward(self, x):
        return gather_from_model(super().forward(x), self.group)


class ShardedBatchNorm(BatchNorm):
    """This rank's channel chunk of an (E)Pix2Vox ``BatchNorm``: the norm of the
    chunk (statistics over the 'data' group, as the module takes them), gathered
    over 'model'."""

    def __init__(self, norm, shard):
        nn.Module.__init__(self)
        self.eps, self.group, self.model_group = norm.eps, norm.group, shard.group
        self.weight = _take(norm.weight, 0, shard)
        self.bias = _take(norm.bias, 0, shard)

    def forward(self, x):
        return gather_from_model(super().forward(x), self.model_group)


class ShardedEncoderStage(nn.Module):
    """``EncoderStage`` on this rank's feature chunk; replicated in and out."""

    def __init__(self, stage, shard):
        super().__init__()
        self.stride, self.group = stage.stride, shard.group
        self.a_conv = ShardedGroupedConv2d(stage.a_conv, shard)
        self.a_norm = _take_norm(stage.a_norm, shard)
        self.b_conv = ShardedGroupedConv2d(stage.b_conv, shard)
        self.b_norm = _take_norm(stage.b_norm, shard)

    def forward(self, x):
        g = self.group
        x = self.a_conv(copy_to_model(_same_pad_2d(x, self.stride), g))
        x = gather_from_model(_norm_act(self.a_norm, x), g)
        x = self.b_conv(copy_to_model(x, g))
        return gather_from_model(_norm_act(self.b_norm, x), g)


class ShardedDecoderStage(nn.Module):
    """``DecoderStage`` on this rank's feature chunk: the upsampling gathered
    before the skip concat, each 3^3 conv block sharded and gathered."""

    def __init__(self, stage, shard):
        super().__init__()
        self.keep_conv_in, self.group = stage.keep_conv_in, shard.group
        self.up = ShardedConvTranspose3d(stage.up, shard)
        self.a_conv = stage.a_conv
        _take(self.a_conv.weight, 0, shard)
        _take(self.a_conv.bias, 0, shard)
        self.a_norm = _take_norm(stage.a_norm, shard)
        self.b_conv = stage.b_conv
        _take(self.b_conv.weight, 0, shard)
        _take(self.b_conv.bias, 0, shard)
        self.b_norm = _take_norm(stage.b_norm, shard)

    def forward(self, y, embed_skip):
        g = self.group
        y = embed_skip(gather_from_model(self.up(y), g))
        with recompute.keep_residuals(self.keep_conv_in):
            y = self.a_conv(copy_to_model(y, g))
        y = gather_from_model(_norm_act(self.a_norm, y), g)
        with recompute.keep_residuals(self.keep_conv_in):
            y = self.b_conv(copy_to_model(y, g))
        return gather_from_model(_norm_act(self.b_norm, y), g)


def shard_unet(unet, split, mesh):
    """Swap the hybrid U-Net's stages (and head) whose parameters ``split`` names
    for their sharded stand-ins, in place; a module is split whole or not at all."""
    shard = _Shard(mesh)
    for prefix, stages, cls, base in (('encoder', unet.encoder, ShardedEncoderStage,
                                       EncoderStage),
                                      ('decoder', unet.decoder, ShardedDecoderStage,
                                       DecoderStage)):
        for s, stage in enumerate(stages):
            names = [f'{prefix}.{s}.{n}' for n, _ in stage.named_parameters()]
            if _whole(names, split) and isinstance(stage, base):
                stages[s] = cls(stage, shard)
    names = [f'seg_head.{n}' for n, _ in unet.seg_head.named_parameters()]
    if _whole(names, split):
        unet.seg_head = ShardedConv3d(unet.seg_head, shard)
    return unet


def conv_norm_pairs(model):
    """(parent, conv name, norm name) of every conv that feeds a ``BatchNorm`` in
    an (E)Pix2Vox model, in module order: ``convK``/``bnK`` and ``down``/``bn_down``
    in the Bottlenecks, the stem's ``conv1``/``bn1``, ``lK_conv``/``lK_bn``,
    ``upK``/``upK_bn`` and ``mK_conv``/``mK_bn``."""
    for parent in model.modules():
        children = dict(parent.named_children())
        for name, child in children.items():
            if not isinstance(child, BatchNorm):
                continue
            conv = next(c for c in (name.replace('bn', 'conv'), name.replace('_bn', ''),
                                    name.replace('bn_', '')) if c != name and c in children)
            yield parent, conv, name


def shard_epix2vox(model, split, mesh):
    """Set every ``BatchNorm``'s 'data' group (the whole batch's statistics), then
    swap each conv and norm pair whose parameters ``split`` names for its
    stand-ins, in place; a pair, and a Bottleneck, is split whole or not at all.
    Raises if ``split`` names a parameter outside the swapped pairs."""
    shard = _Shard(mesh) if 'model' in mesh.shape else None
    prefix = {m: f'{n}.' if n else '' for n, m in model.named_modules()}

    def names(*modules):
        return [prefix[m] + n for m in modules for n, _ in m.named_parameters()]

    for m in model.modules():
        if isinstance(m, Bottleneck):
            _whole(names(m), split)
    done = set()
    for parent, conv_name, norm_name in list(conv_norm_pairs(model)):
        conv, norm = getattr(parent, conv_name), getattr(parent, norm_name)
        pair = names(conv, norm)
        if not _whole(pair, split):
            continue
        setattr(parent, conv_name,
                ShardedConvTranspose3d(conv, shard) if isinstance(conv, nn.ConvTranspose3d)
                else ShardedConv(conv, shard))
        setattr(parent, norm_name, ShardedBatchNorm(norm, shard))
        done.update(pair)
    if done != set(split):
        raise ValueError(f"split parameters outside a conv and norm pair: "
                         f"{sorted(set(split) - done)}")
    group = mesh.groups['data'] if 'data' in mesh.shape else None
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return model


def shard_model(model, split, mesh):
    """The reconstruction model's stand-ins for ``mesh``: :func:`shard_epix2vox`
    for (E)Pix2Vox, :func:`shard_unet` for the hybrid U-Net (whose instance norms
    are per sample, so only a 'model' split changes it)."""
    if isinstance(model, EPix2VoxModel128):
        return shard_epix2vox(model, split, mesh)
    return shard_unet(model, split, mesh) if split else model


def _whole(names, split):
    hit = [n in split for n in names]
    if any(hit) and not all(hit):
        raise ValueError(f"a module's parameters are split in part: "
                         f"{[n for n, h in zip(names, hit) if h]} of {names}")
    return all(hit)
