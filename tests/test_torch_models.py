"""The port's models against the JAX package's flax models, on the CPU in float32,
with the flax params converted by ``acquisition_focus_tpu_torch.convert``:
localization nets and affine transform modules (thetas), the hybrid U-Net (logits and
gradients), the transposed-conv kernel flip, and the port's initializer.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from acquisition_focus_tpu.models import atm as jatm
from acquisition_focus_tpu.models.hybrid_unet import HybridUnet as JHybridUnet
from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu_torch.convert import (
    _conv_transpose, atm_state_dicts, unet_state_dict)
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.models import atm as tatm
from acquisition_focus_tpu_torch.models.hybrid_unet import HybridUnet


def T(a):
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rotation_affines(rng, n, offset=0.2):
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out[i, :3, :3] = q
        out[i, :3, 3] = rng.uniform(-offset, offset, 3)
    return out.astype(np.float32)


def close_scaled(got, ref, atol):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale, atol=atol)


# ---------------------------------------------------------------- ATM heads

@pytest.mark.parametrize('method', ['R6-vector', 'normal-vector', 'angle-axis'])
@pytest.mark.parametrize('offset_clip,zoom_clip', [(0.2, 0.0), (0.0, 0.1)])
def test_atm_theta_from_heads_matches(rng, method, offset_clip, zoom_clip):
    spat = 32
    ap = 6 if method == 'R6-vector' else 3
    n = ap + 3 * jatm.vox_range_for_clip(offset_clip, spat) + 1
    head = rng.normal(size=(3, n)).astype(np.float32)
    args = (method, spat, offset_clip, zoom_clip)
    ref, vjp = jax.vjp(lambda h: jatm.atm_theta_from_heads(h, *args), jnp.asarray(head))
    g = rng.normal(size=ref.shape).astype(np.float32)
    h = T(head).requires_grad_()
    out = tatm.atm_theta_from_heads(h, *args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    (out * T(g)).sum().backward()
    close_scaled(h.grad.numpy(), vjp(jnp.asarray(g))[0], 1e-5)


def test_stacked_atms_thetas_match(rng):
    """apply_stacked_atms over converted StackedATMs params: 2 views, 32^3 prescans
    (the JAX package runs the even-sized stages space-to-depth; the port plainly)."""
    V, B, C, P = 2, 2, 3, 32
    x = rng.random((V, B, P, P, P, C)).astype(np.float32)
    mod = jatm.StackedATMs(n_views=V, prescan_spat=P, locnet_width=2)
    params = mod.init(jax.random.key(1), jnp.asarray(x))
    kw = dict(optim_method='R6-vector', prescan_spat=P, offset_clip_value=0.2,
              zoom_clip_value=0.0, locnet_width=2)
    ref = jatm.apply_stacked_atms(params, jnp.asarray(x), **kw)
    atms = torch.nn.ModuleList([tatm.AffineTransformModule(C, prescan_spat=P,
                                                           locnet_width=2)
                                for _ in range(V)])
    for m, sd in zip(atms, atm_state_dicts(to_np(params))):
        m.load_state_dict(sd)
    out = tatm.apply_stacked_atms(atms, T(x).permute(0, 1, 5, 2, 3, 4),
                                  train_mask=[False, True])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5)


def test_frozen_view_builds_no_graph(rng):
    atms = torch.nn.ModuleList([tatm.AffineTransformModule(2, prescan_spat=16,
                                                           locnet_width=2)
                                for _ in range(2)])
    x = T(rng.random((2, 1, 2, 16, 16, 16)))
    thetas = tatm.apply_stacked_atms(atms, x, train_mask=[False, True])
    thetas.sum().backward()
    assert all(p.grad is None for p in atms[0].parameters())
    assert all(p.grad is not None for p in atms[1].parameters())


# ---------------------------------------------------------------- hybrid U-Net

UNET = dict(n_views=2, num_classes=3, base_features=(4, 8, 8))


@pytest.fixture(scope='module')
def unet_pair():
    """A flax HybridUnet at 16^3 with random params (norm scales and biases
    included) and its converted port; three levels keep the smallest instance
    norm at 4 x 4."""
    rng = np.random.default_rng(0)
    S, B = 16, 2
    V, C = UNET['n_views'], UNET['num_classes']
    x = rng.random((B, V * C, S, S)).astype(np.float32)
    aff = rotation_affines(rng, V * B).reshape(V, B, 4, 4)
    jmod = JHybridUnet(**UNET, dtype=jnp.float32, remat_skips=False,
                       decoder_save_names=('conv_out',))
    params = jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x), jnp.asarray(aff))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(7), p.shape), params)
    tmod = HybridUnet(**UNET)
    tmod.load_state_dict(unet_state_dict(to_np(params)))
    return dict(x=x, aff=aff, jmod=jmod, params=params, tmod=tmod, rng=rng)


def test_hybrid_unet_forward_matches(unet_pair):
    d = unet_pair
    ref = jax.jit(d['jmod'].apply)(d['params'], jnp.asarray(d['x']), jnp.asarray(d['aff']))
    out = d['tmod'](T(d['x']), T(d['aff']))
    assert out.shape == (2, 3, 16, 16, 16)
    close_scaled(out.detach().numpy(), ref, 1e-5)


def test_hybrid_unet_grads_match(unet_pair):
    """Parameter and input gradients of sum(logits * g) from identical inputs; the
    conv biases in front of an instance norm have an exact gradient of zero, of
    which both frameworks keep only rounding noise."""
    d = unet_pair
    g = d['rng'].normal(size=(2, 3, 16, 16, 16)).astype(np.float32)

    def loss(p, x):
        return (d['jmod'].apply(p, x, jnp.asarray(d['aff'])) * g).sum()

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(d['params'], jnp.asarray(d['x']))
    ref = unet_state_dict(to_np(gp))
    x = T(d['x']).requires_grad_()
    d['tmod'].zero_grad()
    (d['tmod'](x, T(d['aff'])) * T(g)).sum().backward()
    close_scaled(x.grad.numpy(), gx, 1e-4)
    top = max(float(t.abs().max()) for t in ref.values())
    for name, p in d['tmod'].named_parameters():
        if name.endswith('conv.bias'):
            assert max(p.grad.abs().max(), ref[name].abs().max()) <= 1e-5 * top, name
        else:
            close_scaled(p.grad.numpy(), ref[name].numpy(), 1e-4)


def test_hybrid_unet_with_a_single_voxel_level_matches():
    """Five levels at 16^3, as six at 32^3 (the reference widths at the smoke
    configs' size): the deepest instance norms see one voxel, where the normalized
    value is 0 and the output the norm's bias, in both frameworks. The levels of
    2^3 voxels above it amplify rounding: within 1e-4. The port's gradient through
    that level is exactly 0 for the input and the norm's scale."""
    rng = np.random.default_rng(1)
    kw = dict(n_views=2, num_classes=3, base_features=(2, 2, 4, 4, 4))
    x = rng.random((1, 6, 16, 16)).astype(np.float32)
    aff = rotation_affines(rng, 2).reshape(2, 1, 4, 4)
    jmod = JHybridUnet(**kw, dtype=jnp.float32, remat_skips=False,
                       decoder_save_names=('conv_out',))
    params = jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x), jnp.asarray(aff))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(np.float32), params)
    ref = jax.jit(jmod.apply)(params, jnp.asarray(x), jnp.asarray(aff))
    tmod = HybridUnet(**kw)
    tmod.load_state_dict(unet_state_dict(to_np(params)))
    out = tmod(T(x), T(aff))
    close_scaled(out.detach().numpy(), ref, 1e-4)
    out.sum().backward()
    deepest = dict(tmod.named_parameters())
    assert float(deepest['encoder.4.a_norm.weight'].grad.abs().max()) == 0.0
    assert float(deepest['encoder.4.b_norm.bias'].grad.abs().max()) > 0.0


def test_conv_transpose_needs_the_kernel_flip(rng):
    """flax ConvTranspose((2,2,2), strides=2) equals torch ConvTranspose3d only with
    the kernel flipped on all three spatial axes."""
    x = rng.normal(size=(1, 4, 4, 4, 5)).astype(np.float32)
    mod = fnn.ConvTranspose(3, (2, 2, 2), strides=(2, 2, 2))
    params = mod.init(jax.random.key(0), jnp.asarray(x))
    ref = np.asarray(mod.apply(params, jnp.asarray(x))).transpose(0, 4, 1, 2, 3)
    kernel = np.asarray(params['params']['kernel'])
    conv = torch.nn.ConvTranspose3d(5, 3, 2, stride=2)
    conv.bias.data = T(params['params']['bias'])
    xt = T(x.transpose(0, 4, 1, 2, 3))
    conv.weight.data = T(_conv_transpose(kernel))
    np.testing.assert_allclose(conv(xt).detach().numpy(), ref, atol=1e-5)
    conv.weight.data = T(kernel.transpose(3, 4, 0, 1, 2))          # unflipped
    assert np.abs(conv(xt).detach().numpy() - ref).max() > 0.1


# ---------------------------------------------------------------- initializer

def test_init_matches_flax_distributions():
    """lecun-normal (truncated at 2 std) weights, zero biases, unit norm scales: the
    per-leaf std of the port's init within 10% of flax's."""
    kw = dict(n_views=2, num_classes=3, n_active_views=2,
              view_optimization_mode='opt-all', use_affine_theta=True,
              hires_fov_vox=(16,) * 3, slice_fov_vox=(16, 16, 1),
              prescan_fov_vox=(32,) * 3,
              base_features=(8, 16, 16), locnet_width=4, compute_dtype='float32')
    up, ap = jtrain.init_params(jtrain.StageSpec(**kw), jax.random.key(0))
    unet, atms = ttrain.make_models(ttrain.StageSpec(**kw), 'cpu')
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(0))
    refs = dict(unet_state_dict(to_np(up)))
    for v, sd in enumerate(atm_state_dicts(to_np(ap))):
        refs.update({f'{v}.{k}': t for k, t in sd.items()})
    ours = dict(unet.named_parameters())
    ours.update({f'{v}.{k}': p for v, m in enumerate(atms) for k, p in m.named_parameters()})
    assert set(ours) == set(refs)
    for name, p in ours.items():
        ref, got = refs[name].numpy(), p.detach().numpy()
        if name.endswith('bias'):
            assert not got.any(), name
        elif 'norm' in name:
            assert (got == 1).all(), name
        else:
            assert abs(got.std() / ref.std() - 1) < 0.1 or got.size < 200, name
            assert np.abs(got).max() <= 2 * got.std() * 1.2 + 1e-6, name
