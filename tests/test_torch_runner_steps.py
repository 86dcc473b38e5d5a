"""The steps of the port's runner path against the JAX package's, on the CPU in
float32: ``theta_pass``, ``eval_step`` (with and without slice upsampling), the
cached-theta ``train_step``, ``resize_trilinear``, and the evaluation metrics.

The steps start from converted flax params on the skinny spec of
``test_torch_train_step.py``, augmentation off, batch seed 4 (no point near a
kink of the gradient, see that file).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from acquisition_focus_tpu.engine import metrics as jmetrics
from acquisition_focus_tpu.engine import optimizers as jopt
from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu.geometry.clinical_views import get_class_volumes as jvolumes
from acquisition_focus_tpu.ops.resample import resize_trilinear as jresize
from acquisition_focus_tpu_torch.data import make_heart_phantom
from acquisition_focus_tpu_torch.engine import metrics as tmetrics
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.geometry.clinical_views import get_class_volumes
from acquisition_focus_tpu_torch.ops.resample import resize_trilinear
from test_torch_train_step import (
    BATCH_SEED, EPOCHS, LR, SKINNY, UPE, all_pairs, leaf_scales, make_batch, to_np,
    torch_batch, torch_setup)


def micro(batch, i=0):
    return {k: v[i] for k, v in batch.items()}


@pytest.fixture(scope='module')
def models():
    """The JAX package's flax params on the skinny spec, and the port's modules
    loaded with them."""
    spec_j = jtrain.StageSpec(**SKINNY)
    unet_j, atms_j = jtrain.make_models(spec_j)
    up, ap = jtrain.init_params(spec_j, jax.random.key(0))
    up_np, ap_np = to_np(up), to_np(ap)
    unet, atms, _, _ = torch_setup(ttrain.StageSpec(**SKINNY), up_np, ap_np)
    return dict(unet_j=unet_j, atms_j=atms_j, up=up, ap=ap, up_np=up_np, ap_np=ap_np,
                unet=unet, atms=atms, batch=make_batch(spec_j, np.random.default_rng(BATCH_SEED)))


def test_theta_pass_matches_jax(models):
    m = models
    spec = ttrain.StageSpec(**SKINNY)
    ref = jtrain.theta_pass(jtrain.StageSpec(**SKINNY), m['ap'],
                            {k: jnp.asarray(v) for k, v in micro(m['batch']).items()})
    got = ttrain.theta_pass(spec, m['atms'], torch_batch(micro(m['batch'])))
    assert got.shape == (2, 1, 4, 4) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('slice_vox', [16, 8])
def test_eval_step_matches_jax(models, slice_vox):
    """Loss, dice, predictions, view geometry and model input; at slice_vox 8 the
    slices are upsampled to the 16^2 hires plane (``resize_trilinear``)."""
    m = models
    kw = dict(SKINNY, slice_fov_vox=(slice_vox, slice_vox, 1))
    b = micro(m['batch'], 1)
    ref = jtrain.eval_step(jtrain.StageSpec(**kw), m['unet_j'], m['atms_j'], m['up'],
                           m['ap'], {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.key(0))
    got = ttrain.eval_step(ttrain.StageSpec(**kw), m['unet'], m['atms'], torch_batch(b))
    np.testing.assert_allclose(float(got['loss']), float(ref['loss']), rtol=1e-5)
    np.testing.assert_allclose(got['dice'].numpy(), np.asarray(ref['dice']), atol=1e-6,
                               equal_nan=True)
    np.testing.assert_array_equal(got['pred'].numpy(), np.asarray(ref['pred']))
    for k in ('thetas', 'grid_affines', 'out_nii_affines', 'b_input'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)


def test_cached_theta_train_step_matches_jax(models):
    """theta_source='cached': thetas come from the batch (here theta_pass's), no
    locnet runs, the ATMs keep their params and the transform schedule does not
    advance; loss, dice and the U-Net's update match the JAX step (tolerances of
    test_torch_train_step.py)."""
    m = models
    spec_j = jtrain.StageSpec(**dict(SKINNY, theta_source='cached'))
    spec_t = ttrain.StageSpec(**dict(SKINNY, theta_source='cached'))
    batch = dict(m['batch'])
    batch['thetas'] = np.stack([np.asarray(jtrain.theta_pass(
        jtrain.StageSpec(**SKINNY), m['ap'], {k: jnp.asarray(v) for k, v in
                                              micro(batch, i).items()}))
        for i in range(spec_j.num_grad_accum_steps)])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(u_p, mb):
        return jtrain.forward(spec_j, m['unet_j'], u_p, m['atms_j'], m['ap'], mb, None,
                              train=True)[0]

    grad_fn = jax.jit(jax.grad(loss_fn))
    accum = spec_j.num_grad_accum_steps
    grads = [grad_fn(m['up'], {k: v[i] for k, v in jb.items()}) for i in range(accum)]
    grads_j = jax.tree_util.tree_map(lambda *g: sum(np.asarray(x) for x in g) / accum, *grads)
    r_opt = jopt.make_reconstruction_optimizer(LR, UPE)
    t_opt = jopt.make_transform_optimizer(LR, EPOCHS, UPE)
    up, ap = jax.tree_util.tree_map(jnp.array, (m['up_np'], m['ap_np']))
    new_up, new_ap, _, t_state, metrics_j, _ = jtrain.train_step(
        spec_j, m['unet_j'], m['atms_j'], r_opt, t_opt, up, ap, r_opt.init(up),
        t_opt.init(ap), jb, jax.random.key(0))

    unet, atms, r, t = torch_setup(spec_t, m['up_np'], m['ap_np'])
    metrics_t = ttrain.train_step(spec_t, unet, atms, r, t, torch_batch(batch))
    np.testing.assert_allclose(float(metrics_t['loss']), float(metrics_j['loss']), rtol=1e-5)
    np.testing.assert_allclose(metrics_t['dice'].numpy(), np.asarray(metrics_j['dice']),
                               atol=1e-6, equal_nan=True)

    # all_pairs reads the ATM gradients from grads_j[1]; the ATMs' check below
    # needs none, so the params stand in for them
    d = dict(grads_j=(grads_j, m['ap_np']), new_up=to_np(new_up), new_ap=to_np(new_ap),
             unet=unet, atms=atms)
    grads_j = {n: ref for n, ref, _ in all_pairs(d, 'grad')}
    scales = {n: v for n, v in leaf_scales(d).items() if n.startswith(('encoder', 'decoder',
                                                                       'seg_head'))}
    n_checked = 0
    for name, ref, p in all_pairs(d, 'param'):
        if name.startswith('view'):      # ATMs: untouched on both sides
            np.testing.assert_array_equal(p.detach().numpy(), ref, err_msg=name)
            continue
        if name.endswith('conv.bias'):
            continue
        sel = np.abs(grads_j[name]) > 1e-3 * scales[name]
        np.testing.assert_allclose(p.detach().numpy()[sel], ref[sel], atol=1e-5,
                                   err_msg=name)
        n_checked += int(sel.sum())
    assert n_checked > 0
    assert t[1].last_epoch == 0
    assert int(jax.tree_util.tree_leaves(t_state)[0]) == 0   # optax count untouched



# ---------------------------------------------------------------- resize, metrics

@pytest.mark.parametrize('shape,out', [((2, 3, 8, 8, 1), (16, 16, 1)),
                                       ((1, 2, 5, 7, 1), (16, 16, 1)),
                                       ((1, 2, 4, 6, 3), (8, 12, 9))])
def test_resize_trilinear_matches_jax(rng, shape, out):
    """Enlarging only, as the step does (jax.image.resize antialiases when it
    shrinks, F.interpolate does not)."""
    x = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(resize_trilinear(torch.from_numpy(x), out).numpy(),
                               np.asarray(jresize(jnp.asarray(x), out)), atol=1e-5)


def phantom_labels(shape, seeds):
    return np.stack([make_heart_phantom(shape, seed=s)[0] for s in seeds])


@pytest.fixture(scope='module')
def label_pair():
    """Predicted and target labels (2, 24^3), 6 classes: phantoms of other seeds,
    with class 5 missing from the first prediction and class 4 from the second
    target (NaN scores)."""
    pred = phantom_labels((24,) * 3, (0, 1))
    target = phantom_labels((24,) * 3, (2, 3))
    pred[0][pred[0] == 5] = 0
    target[1][target[1] == 4] = 0
    return pred, target


def test_iou_per_class_labels_matches_jax(label_pair):
    pred, target = label_pair
    got = tmetrics.iou_per_class_labels(torch.from_numpy(pred), torch.from_numpy(target), 6)
    ref = jmetrics.iou_per_class_labels(pred, target, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, equal_nan=True)
    assert np.isnan(float(got[1, 4]))


@pytest.mark.parametrize('percentile', [None, 95])
def test_host_hausdorff_matches_jax(label_pair, percentile):
    pred, target = label_pair
    np.testing.assert_array_equal(
        tmetrics.hausdorff_per_class(pred, target, 6, percentile),
        jmetrics.hausdorff_per_class(pred, target, 6, percentile))


@pytest.mark.parametrize('chunk', [None, 24 * 24 * 7])
def test_device_hausdorff_matches_jax(label_pair, monkeypatch, chunk):
    """The torch min-plus path (here on CPU tensors) against the JAX package's
    device path and the host path; ``chunk`` forces row chunks of 7, which do not
    divide the 576 rows of a pass."""
    if chunk is not None:
        monkeypatch.setattr(tmetrics, '_MINPLUS_CHUNK', chunk)
    pred, target = label_pair
    got = tmetrics.hausdorff_per_class_device(torch.from_numpy(pred),
                                              torch.from_numpy(target), 6).numpy()
    ref = np.asarray(jmetrics.hausdorff_per_class_device(pred, target, 6))
    np.testing.assert_allclose(got, ref, rtol=1e-5, equal_nan=True)
    host = np.stack([jmetrics.hausdorff_per_class(pred, target, 6),
                     jmetrics.hausdorff_per_class(pred, target, 6, 95)], axis=-1)
    np.testing.assert_allclose(got, host, rtol=1e-5, equal_nan=True)
    assert np.isnan(got[0, 5]).all() and np.isnan(got[1, 4]).all()


def test_edt_squared_matches_scipy(rng):
    from scipy.ndimage import distance_transform_edt
    mask = rng.random((9, 12, 10)) < 0.03
    got = tmetrics.edt_squared_device(torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, distance_transform_edt(~mask) ** 2, rtol=1e-6)


def test_label_score_bookkeeping_matches_jax(rng):
    tags = ('background', 'MYO', 'LV')
    store_t, store_j = {}, {}
    for _ in range(3):
        scores = rng.random((2, 3))
        scores[0, 1] = np.nan
        tmetrics.accumulate_label_scores(store_t, 'dice', scores, tags)
        jmetrics.accumulate_label_scores(store_j, 'dice', scores, tags)
    np.testing.assert_equal(store_t, store_j)
    np.testing.assert_equal(tmetrics.reduce_label_scores(store_t),
                            jmetrics.reduce_label_scores(store_j))


def test_class_volumes_match_jax(label_pair):
    pred, _ = label_pair
    spacing = np.array([[1.5, 1.5, 1.5], [1.0, 2.0, 1.5]], np.float32)
    for unit in ('ml', 'mm3'):
        np.testing.assert_allclose(
            get_class_volumes(torch.from_numpy(pred), spacing, 6, unit).numpy(),
            np.asarray(jvolumes(pred, spacing, 6, unit)), rtol=1e-6)
