"""The step's from-segmented and slice-alignment options against the JAX package's,
on the CPU in float32: ``slice_min_principal_align_affines``, ``segment_slices``
(the frozen segmenter on the image slices), a from-segmented ``eval_step``, and
``rotate_slice_to_min_principle`` in the eval step and in training (one
``train_step`` against the JAX package's: ``test_torch_rotate_step.py``).

The steps start from flax params converted with ``convert.py`` on a narrow 32^3
spec, on phantom labels and images (the alignment needs structured slices: on
noise the min-inertia axis is ill-conditioned), augmentation off. Tolerances,
with the largest gap measured beside each: alignment affines 1e-5 (8.9e-7);
segmented slices 1e-5; losses 1e-4 of their value; model inputs 1e-5, and 1e-4
after the alignment (2.7e-5: one-hot slices resampled twice through affines
~1e-6 apart); affines 1e-5 of their largest magnitude (the NIfTI ones are in mm).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu.geometry.moments import (
    slice_min_principal_align_affines as jalign)
from acquisition_focus_tpu.models.segmentation.unet2d import SegUnet2D as JSegUnet2D
from acquisition_focus_tpu_torch.convert import load_flax_params, segunet_state_dict
from acquisition_focus_tpu_torch.data.synthetic import make_heart_phantom
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.optimizers import (
    make_reconstruction_optimizer, make_transform_optimizer)
from acquisition_focus_tpu_torch.geometry.moments import slice_min_principal_align_affines
from acquisition_focus_tpu_torch.models.segmentation import SegUnet2D

SPAT = 32
SEG_SPEC = dict(n_views=2, num_classes=6, n_active_views=2, view_optimization_mode='opt-all',
                use_affine_theta=True, hires_fov_mm=(48.0,) * 3, hires_fov_vox=(SPAT,) * 3,
                slice_fov_mm=(48.0, 48.0, 3.0), slice_fov_vox=(16, 16, 1),
                prescan_fov_mm=(48.0,) * 3, prescan_fov_vox=(SPAT,) * 3,
                num_grad_accum_steps=1, compute_dtype='float32', augment_input=False,
                base_features=(4, 8, 8), locnet_width=2,
                label_slice_type='from-segmented')
ROTATE = dict(SEG_SPEC, label_slice_type='from-gt', rotate_slice_to_min_principle=True,
              slice_fov_mm=(48.0, 48.0, 1.5), slice_fov_vox=(SPAT, SPAT, 1))


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def phantom_slices():
    """(N, 32, 32, 1) slices of phantom labels across both in-plane axes, an empty
    one included."""
    lbl = make_heart_phantom((SPAT,) * 3, seed=1)[0]
    sl = [lbl[i] for i in range(6, 26, 2)] + [lbl[:, i] for i in range(6, 26, 3)]
    return np.stack(sl + [np.zeros_like(lbl[0])])[..., None].astype(np.int32)


def test_slice_alignment_matches_jax():
    sl = phantom_slices()
    ref = np.asarray(jalign(jnp.asarray(sl)))
    got = slice_min_principal_align_affines(torch.from_numpy(sl))
    assert got.shape == (len(sl), 4, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.fixture(scope='module')
def tiny_segmenter():
    """A (4, 8)-wide SegUnet2D from flax's init, and the port's copy."""
    jm = JSegUnet2D(num_classes=6, features=(4, 8))
    params = jax.jit(jm.init)(jax.random.key(2), jnp.zeros((1, 32, 32, 1)))
    model = SegUnet2D(6, (4, 8))
    model.load_state_dict(segunet_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, model.eval().requires_grad_(False)


def test_segment_slices_respaced_matches_jax(tiny_segmenter):
    """16^2 slices at 3 mm: respaced to the segmenter's 32^2 1.5 mm grid, then the
    one-hot prediction goes to the 32^2 hires plane (the case of
    ``tests/test_train_step.py``'s from-segmented eval)."""
    jm, params, model = tiny_segmenter
    rng = np.random.default_rng(5)
    img = make_heart_phantom((SPAT,) * 3, seed=3)[1][8:24:4, ::2, ::2]
    slices = (img.reshape(2, 2, 1, 16, 16)
              + 0.01 * rng.normal(size=(2, 2, 1, 16, 16))).astype(np.float32)
    ref = np.asarray(jtrain._segment_slices_in_jit(jtrain.StageSpec(**SEG_SPEC), jm, params,
                                                   jnp.asarray(slices)))
    got = ttrain.segment_slices(ttrain.StageSpec(**SEG_SPEC), model,
                                torch.from_numpy(slices)).numpy()
    assert got.shape == ref.shape == (2, 2, 6, SPAT, SPAT)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.fixture(scope='module')
def step_models():
    """Flax params of the reconstruction and localization nets on SEG_SPEC, and the
    port's modules loaded with them."""
    spec_j = jtrain.StageSpec(**SEG_SPEC)
    unet_j, atms_j = jtrain.make_models(spec_j)
    up, ap = jtrain.init_params(spec_j, jax.random.key(0))
    unet, atms = ttrain.make_models(ttrain.StageSpec(**SEG_SPEC), 'cpu')
    load_flax_params(unet, atms, *(jax.tree_util.tree_map(np.array, t) for t in (up, ap)))
    return unet_j, atms_j, up, ap, unet, atms


def phantom_batch():
    """One phantom case: label, image, NIfTI affine, two view affines (identity and
    a quarter turn, each with a small offset)."""
    label, image, _ = make_heart_phantom((SPAT,) * 3, seed=10)
    views = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1, 1))
    views[1, :, :3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    views[:, :, :3, 3] = np.random.default_rng(6).uniform(-0.05, 0.05, (2, 1, 3))
    return {'label': label[None].astype(np.int32), 'image': image[None].astype(np.float32),
            'nii_affine': np.diag([1.5, 1.5, 1.5, 1.0]).astype(np.float32)[None],
            'view_affines': views}


def assert_close(got, ref, keys, atol):
    for k in keys:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].detach().numpy(), r,
                                   atol=atol * max(1.0, np.abs(r).max()), err_msg=k)


def test_from_segmented_eval_step_matches_jax(step_models, tiny_segmenter):
    """label_slice_type='from-segmented' at 16^2 slices (3 mm, respaced for the
    segmenter): the segmented model input, the loss and the geometry."""
    unet_j, atms_j, up, ap, unet, atms = step_models
    jm, params, model = tiny_segmenter
    batch = phantom_batch()
    ref = jtrain.eval_step(jtrain.StageSpec(**SEG_SPEC), unet_j, atms_j, up, ap,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(0), seg_model=jm, seg_params=params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = ttrain.eval_step(ttrain.StageSpec(**SEG_SPEC), unet.eval(), atms.eval(), tb,
                           segmenter=model)
    np.testing.assert_allclose(float(got['loss']), float(ref['loss']), rtol=1e-4)
    assert_close(got, ref, ('b_input', 'thetas', 'grid_affines', 'out_nii_affines'), 1e-5)
    # without the segmenter the same step slices the label: another model input
    plain = ttrain.eval_step(ttrain.StageSpec(**SEG_SPEC), unet, atms, tb)
    assert not torch.equal(plain['b_input'], got['b_input'])


def test_rotate_slice_to_min_principle_eval_step_matches_jax(step_models):
    """The aligned slices (the model input), their affines and the loss."""
    unet_j, atms_j, up, ap, unet, atms = step_models
    batch = phantom_batch()
    ref = jtrain.eval_step(jtrain.StageSpec(**ROTATE), unet_j, atms_j, up, ap,
                           {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    got = ttrain.eval_step(ttrain.StageSpec(**ROTATE), unet.eval(), atms.eval(),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got['loss']), float(ref['loss']), rtol=1e-4)
    assert_close(got, ref, ('b_input',), 1e-4)
    assert_close(got, ref, ('grid_affines', 'out_nii_affines', 'thetas'), 1e-5)
    plain = ttrain.eval_step(ttrain.StageSpec(**dict(ROTATE, rotate_slice_to_min_principle=False)),
                             unet, atms, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not torch.allclose(plain['grid_affines'], got['grid_affines'])


def test_rotate_slice_to_min_principle_trains():
    """Training steps with the alignment: the gradient reaches the reconstruction
    model and the localization nets through the aligned slices, losses finite."""
    spec = ttrain.StageSpec(**dict(ROTATE, num_grad_accum_steps=2))
    unet, atms = ttrain.make_models(spec, 'cpu')
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(0))
    r_opt = make_reconstruction_optimizer(unet.parameters(), 1e-3, 2)
    t_opt = make_transform_optimizer(atms.parameters(), 1e-3, 4, 2)
    b = phantom_batch()
    batch = {k: torch.from_numpy(np.stack([v, v])) for k, v in b.items() if k != 'image'}
    before = [p.detach().clone() for p in atms.parameters()]
    losses = [float(ttrain.train_step(spec, unet, atms, r_opt, t_opt, batch)['loss'])
              for _ in range(2)]
    assert np.isfinite(losses).all()
    assert any(not torch.equal(a, p) for a, p in zip(before, atms.parameters()))

