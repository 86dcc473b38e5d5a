"""The port's sharding rules (``acquisition_focus_tpu_torch/parallel``) against the
JAX package's (``acquisition_focus_tpu/parallel/mesh.py``), with no process group:

* at reference widths with 3 views and 6 classes, the U-Net parameters and AdamW
  moments that a 'model' axis of 2 and of 4 splits are the leaves that the JAX
  package's ``shard_params`` / ``shard_opt_state`` split on the conftest's 8
  virtual devices, named through ``convert.unet_state_dict`` and split along the
  torch axis that holds flax's output-feature axis (axis 1 of a ConvTranspose3d
  weight, axis 0 of everything else);
* ``batch_shardings`` gives JAX's split axis for every key, train and eval;
* a grouped conv's output-channel slices, computed one group piece at a time,
  are the grouped conv's.

The parameters are shapes only (JAX: ``jax.eval_shape``; the port: the meta
device), the JAX leaves zeros of those shapes.
"""

import numpy as np
import pytest
import jax
import torch
import torch.nn as nn

from acquisition_focus_tpu.engine import optimizers as jopt
from acquisition_focus_tpu.engine import runner as jrunner
from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu.engine.config import DEFAULTS
from acquisition_focus_tpu.parallel import mesh as jmesh
from acquisition_focus_tpu_torch.convert import unet_state_dict
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.runner import spec_from_config
from acquisition_focus_tpu_torch.parallel import feature_parallel as fp
from acquisition_focus_tpu_torch.parallel.mesh import (
    Mesh, batch_shardings, feature_split_dims, shard_opt_state)


def fake_mesh(shape, index=0):
    """A Mesh with no process group: enough for the rules and the slicing."""
    return Mesh(shape=dict(shape), device_mesh=None,
                coords={k: index if k == 'model' else 0 for k in shape},
                groups={'model': None}, device=torch.device('cpu'))


@pytest.fixture(scope='module')
def jax_unet_zeros():
    spec = jrunner.spec_from_config(DEFAULTS, 6, 3)
    shapes = jax.eval_shape(lambda: jtrain.init_params(spec, jax.random.key(0)))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def jax_split(tree):
    """{port name: torch split axis} of the leaves of a flax U-Net tree whose
    sharding names 'model': each leaf replaced by a marker of its rank whose
    last (output-feature) axis has length 2 and, where split, a 1 in it; the
    conversion puts that axis where the port holds it."""
    def marker(leaf):
        m = np.zeros((1,) * (leaf.ndim - 1) + (2,), np.float32)
        if any(ax == 'model' for ax in leaf.sharding.spec):
            m[..., 1] = 1.0
        return m
    converted = unet_state_dict(jax.tree_util.tree_map(marker, tree))
    return {k: v.shape.index(2) for k, v in converted.items() if float(v.sum()) > 0}


def port_unet():
    """The reference-width hybrid U-Net on the meta device."""
    with torch.device('meta'):
        unet, _ = ttrain.make_models(spec_from_config(DEFAULTS, 6, 3), 'meta')
    return unet


@pytest.mark.parametrize('m', [2, 4])
def test_param_split_matches_jax(jax_unet_zeros, m):
    mesh = jmesh.make_mesh({'data': 8 // m, 'model': m})
    unet_params, _ = jmesh.shard_params(jax_unet_zeros[0], jax_unet_zeros[1], mesh)
    want = jax_split(unet_params)
    got = feature_split_dims(port_unet(), m)
    assert got == want
    assert got['decoder.0.up.weight'] == 1
    assert ('seg_head.weight' in got) == (m == 2)     # 6 classes


@pytest.mark.parametrize('m', [2, 4])
def test_opt_state_split_matches_jax(jax_unet_zeros, m):
    """AdamW's moments split as their parameters, in both packages: the port's
    ``shard_opt_state`` after ``shard_unet`` slices exactly the moments of the
    leaves whose optax mu and nu the JAX package splits."""
    mesh = jmesh.make_mesh({'data': 8 // m, 'model': m})
    opt = jopt.make_reconstruction_optimizer(1e-3, 2)
    state = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   jax.eval_shape(opt.init, jax_unet_zeros[0]))
    state = jmesh.shard_opt_state(state, mesh)
    adam = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: hasattr(x, 'mu')) if hasattr(s, 'mu')]
    assert len(adam) == 1
    want = jax_split(adam[0].mu)
    assert jax_split(adam[0].nu) == want

    unet = port_unet()
    split = feature_split_dims(unet, m)
    full = {n: tuple(p.shape) for n, p in unet.named_parameters()}
    torch_opt = torch.optim.AdamW(unet.parameters())
    for p in unet.parameters():
        torch_opt.state[p] = {'step': torch.tensor(1.0), 'exp_avg': torch.zeros_like(p),
                              'exp_avg_sq': torch.zeros_like(p)}
    fake = fake_mesh({'data': 8 // m, 'model': m})
    fp.shard_unet(unet, split, fake)
    shard_opt_state(torch_opt, unet, split, fake)
    sliced = {}
    for n, p in unet.named_parameters():
        st = torch_opt.state[p]
        assert st['exp_avg'].shape == st['exp_avg_sq'].shape == p.shape, n
        if tuple(p.shape) != full[n]:
            sliced[n] = [a != b for a, b in zip(p.shape, full[n])].index(True)
    assert sliced == want
    # every stage was swapped for its sharded stand-in; the head only where split
    assert all(isinstance(s, fp.ShardedEncoderStage) for s in unet.encoder)
    assert all(isinstance(s, fp.ShardedDecoderStage) for s in unet.decoder)
    assert isinstance(unet.seg_head, fp.ShardedConv3d) == (m == 2)


@pytest.mark.parametrize('shape', [{'data': 2, 'model': 2}, {'data': 4}, {'model': 4},
                                   {'model': 2, 'data': 4}])
@pytest.mark.parametrize('train', [True, False])
def test_batch_shardings_match_jax(shape, train):
    want = {k: (list(spec).index('data') if 'data' in spec else None)
            for k, spec in jmesh.batch_shardings(jmesh.make_mesh(shape), train).items()}
    assert batch_shardings(fake_mesh(shape), train) == want


@pytest.mark.parametrize('co,groups,m', [(6, 3, 2), (12, 3, 4), (48, 3, 2), (48, 3, 4),
                                         (8, 2, 4), (16, 2, 2)])
def test_grouped_conv_slices_are_the_grouped_conv(co, groups, m):
    """Each rank's pieces (whole groups as one grouped conv, cut groups alone),
    side by side over the ranks: the grouped conv's output, input gradient and
    weight gradient."""
    ci = 6 * groups
    torch.manual_seed(0)
    conv = nn.Conv2d(ci, co, 3, stride=2, groups=groups)
    x = torch.randn(2, ci, 9, 9, requires_grad=True)
    g = torch.randn(2, co, 4, 4)
    ref = conv(x)
    dx_ref, dw_ref = torch.autograd.grad(ref, (x, conv.weight), g)
    outs, dx, dws = [], torch.zeros_like(x), []
    for r in range(m):
        full = nn.Conv2d(ci, co, 3, stride=2, groups=groups)
        full.load_state_dict(conv.state_dict())
        piece = fp.ShardedGroupedConv2d(full, fp._Shard(fake_mesh({'model': m}, r)))
        y = piece(x)
        n = co // m
        gx, gw = torch.autograd.grad(y, (x, piece.weight), g[:, r * n:(r + 1) * n])
        outs.append(y.detach())
        dx += gx
        dws.append(gw)
    torch.testing.assert_close(torch.cat(outs, 1), ref.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat(dws, 0), dw_ref, rtol=1e-5, atol=1e-5)


def test_group_pieces():
    # 48 channels, 3 groups of 16 (6 input channels each), 2 ranks: rank 0 holds
    # group 0 and half of group 1, rank 1 the other half and group 2
    assert fp.group_pieces(0, 24, 16, 6) == [(0, 16, 0, 6, 1), (16, 24, 6, 12, 1)]
    assert fp.group_pieces(24, 48, 16, 6) == [(0, 8, 6, 12, 1), (8, 24, 12, 18, 1)]
    assert fp.group_pieces(0, 48, 16, 6) == [(0, 48, 0, 18, 3)]
    assert fp.group_pieces(12, 24, 16, 6) == [(0, 4, 0, 6, 1), (4, 12, 6, 12, 1)]
