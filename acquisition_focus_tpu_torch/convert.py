"""Convert the JAX package's flax params into this package's state_dicts.

Inputs are the flax param trees as nested dicts of numpy arrays
(``{'params': {...}}``, e.g. ``jax.tree_util.tree_map(np.asarray, params)``):

* ``nn.Conv`` kernels (k..., Ci/groups, Co) -> (Co, Ci/groups, k...): DHWIO -> OIDHW
  and, for the grouped 2D encoder convs, HWIO -> OIHW;
* ``nn.ConvTranspose`` kernels (2, 2, 2, Ci, Co) are flipped on all three spatial
  axes, then transposed to (Ci, Co, 2, 2, 2): flax's transposed conv equals torch's
  ``ConvTranspose3d`` only with the kernel flipped (the segmenter's 2D ones alike);
* ``Dense`` kernels (in, out) -> (out, in);
* GroupNorm scale/bias -> ``InstanceNorm*d(affine=True)`` weight/bias, and the
  EPix2Vox batch norms' scale/bias -> ``models.epix2vox.BatchNorm`` weight/bias;
* the stacked ATM params carry a leading view axis, split across the ModuleList.

The EPix2Vox transposed convs (4^3 stride 2, and the 1^3 head) take the same flip
and transpose as the U-Net's 2^3 ones.
"""

import re

import numpy as np
import torch

from acquisition_focus_tpu_torch.models.epix2vox import EPix2VoxModel128


def _conv(kernel):
    nd = kernel.ndim - 2
    return np.transpose(kernel, (nd + 1, nd) + tuple(range(nd)))


def _conv_transpose(kernel):
    nd = kernel.ndim - 2
    spatial = tuple(range(nd))
    return np.transpose(np.flip(kernel, spatial), (nd, nd + 1) + spatial)


def _layer(out, prefix, p, kernel_fn=_conv):
    if 'kernel' in p:
        out[f'{prefix}.weight'] = kernel_fn(p['kernel'])
        out[f'{prefix}.bias'] = p['bias']
    else:                                   # GroupNorm
        out[f'{prefix}.weight'] = p['scale']
        out[f'{prefix}.bias'] = p['bias']


def _to_torch(sd):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def unet_state_dict(flax_params):
    """HybridUnet params -> ``models.hybrid_unet.HybridUnet`` state_dict."""
    p = flax_params['params']
    out = {}
    for name, leaf in p.items():
        if name.startswith('enc'):
            head, kind = name.split('_', 1)              # 'enc3a', 'conv'
            _layer(out, f'encoder.{head[3:-1]}.{head[-1]}_{kind}', leaf)
        elif name.startswith('dec'):
            for sub, q in leaf.items():
                _layer(out, f'decoder.{name[3:]}.{sub}', q,
                       _conv_transpose if sub == 'up' else _conv)
        elif name == 'seg_head':
            _layer(out, 'seg_head', leaf)
        else:
            raise KeyError(f"unexpected flax param {name!r}")
    return _to_torch(out)


_LOCNET_LAYERS = {f'Conv_{i}': f'locnet.convnet.convs.{i}' for i in range(8)}
_LOCNET_LAYERS['Conv_8'] = 'locnet.convnet.conv8'


def atm_state_dicts(flax_params):
    """StackedATMs params -> one ``AffineTransformModule`` state_dict per view."""
    loc = flax_params['params']['atms']['LocalizationNet_0']
    n_views = loc['Dense_0']['kernel'].shape[0]
    dicts = []
    for v in range(n_views):
        out = {}
        for flax_name, prefix in _LOCNET_LAYERS.items():
            _layer(out, prefix, {k: a[v] for k, a in loc['ConvNet_0'][flax_name].items()})
        dense = loc['Dense_0']
        out['locnet.dense.weight'] = dense['kernel'][v].T
        out['locnet.dense.bias'] = dense['bias'][v]
        dicts.append(_to_torch(out))
    return dicts


# the EPix2Vox modules' transposed convs: the decoder's up{i} and head, the
# refiner's u{i} and u_out
_EPIX_CONV_T = re.compile(r'(up\d+|head|u\d+|u_out)$')


def epix2vox_state_dict(flax_params):
    """EPix2VoxModel128 (or any of its parts, e.g. a bare Epix2VoxRefiner) params
    -> the port module's state_dict: flax's module names are the port's."""
    out = {}

    def walk(prefix, tree):
        if 'scale' in tree:                             # BatchNorm
            out[f'{prefix}weight'] = tree['scale']
            out[f'{prefix}bias'] = tree['bias']
        elif 'kernel' in tree:
            kernel = tree['kernel']
            if kernel.ndim == 2:                        # Dense
                out[f'{prefix}weight'] = kernel.T
            elif _EPIX_CONV_T.match(prefix.rstrip('.').rsplit('.', 1)[-1]):
                out[f'{prefix}weight'] = _conv_transpose(kernel)
            else:
                out[f'{prefix}weight'] = _conv(kernel)
            if 'bias' in tree:
                out[f'{prefix}bias'] = tree['bias']
        else:
            for name, sub in tree.items():
                walk(f'{prefix}{name}.', sub)

    walk('', flax_params['params'])
    return _to_torch(out)


def segunet_state_dict(flax_params):
    """SegUnet2D params (the segmenter checkpoint's 'params') ->
    ``models.segmentation.unet2d.SegUnet2D`` state_dict: flax's layer names are
    the port's module names."""
    p = flax_params['params'] if 'params' in flax_params else flax_params
    out = {}
    for name, leaf in p.items():
        _layer(out, name, leaf, _conv_transpose if name.endswith('_up') else _conv)
    return _to_torch(out)


def load_flax_params(unet, atms, unet_params, atm_params):
    """Load converted flax params into the port's modules (strict); ``unet`` is the
    hybrid U-Net or the EPix2Vox model."""
    unet.load_state_dict(epix2vox_state_dict(unet_params)
                         if isinstance(unet, EPix2VoxModel128)
                         else unet_state_dict(unet_params))
    for module, sd in zip(atms, atm_state_dicts(atm_params)):
        module.load_state_dict(sd)


def load_flax_params_sharded(unet, atms, unet_params, atm_params, split, mesh):
    """:func:`load_flax_params` into a hybrid U-Net already split over a mesh's
    'model' axis (``parallel.shard_params``; ``split`` is what it returned): the
    converted full params are sliced to this rank's share."""
    from acquisition_focus_tpu_torch.engine.checkpoint import load_sharded_state
    load_sharded_state(unet, unet_state_dict(unet_params), split, mesh)
    for module, sd in zip(atms, atm_state_dicts(atm_params)):
        module.load_state_dict(sd)
