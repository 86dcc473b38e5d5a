"""The port's frozen segmenter against the JAX package's, on the CPU in float32:
the segmenter U-Net (flax params converted with ``convert.segunet_state_dict``),
GIN with JAX's draws, the ``jax.image.resize`` twin, sliding-window inference,
``make_segment_fn``, the from-segmented dataset build, the training script, and
the runner's segmenter loading (the step's use of it: ``test_torch_segmented_step.py``).

The segmenter of the serving and build tests is the port's training script run
for 40 steps on 32^3 phantoms (``segmenters``): the JAX side reads it as an orbax
checkpoint of the flax params, the port as the ``torch.save`` file of those params
converted back. Tolerances, with the largest gap measured beside each: U-Net
logits 1e-5 of their largest (1.5e-6); GIN 1e-5 (1.4e-6); resize 1e-6 (2.4e-7);
sliding-window logits 1e-5 of their largest; labels of ``make_segment_fn`` at most
1e-3 of the voxels differ (none did).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from acquisition_focus_tpu.data import cache as jcache
from acquisition_focus_tpu.data.mmwhs import MMWHSDataset as JMMWHS
from acquisition_focus_tpu.engine import segmenter as jseg
from acquisition_focus_tpu.engine.checkpoint import save_checkpoint as jsave_checkpoint
from acquisition_focus_tpu.engine.config import load_config as jload_config
from acquisition_focus_tpu.geometry import centroids as jcent
from acquisition_focus_tpu.models.segmentation import gin as jgin
from acquisition_focus_tpu.models.segmentation.unet2d import SegUnet2D as JSegUnet2D
from acquisition_focus_tpu_torch.convert import segunet_state_dict
from acquisition_focus_tpu_torch.data import base_dataset as tbase
from acquisition_focus_tpu_torch.data import cache as tcache
from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
from acquisition_focus_tpu_torch.data.mmwhs import MMWHSDataset
from acquisition_focus_tpu_torch.data.mrxcat import MRXCATDataset
from acquisition_focus_tpu_torch.data.synthetic import make_heart_phantom, write_phantom_dataset
from acquisition_focus_tpu_torch.engine import runner as trunner
from acquisition_focus_tpu_torch.engine import segmenter as tseg
from acquisition_focus_tpu_torch.engine.config import load_config
from acquisition_focus_tpu_torch.models.segmentation import SegUnet2D, gin_apply, gin_aug
from acquisition_focus_tpu_torch.ops.resample import image_resize
from acquisition_focus_tpu_torch.scripts import train_segmenter

SPAT = 32
GRID = dict(hires_fov_mm=[48.0] * 3, hires_fov_vox=[SPAT] * 3, prescan_fov_mm=[48.0] * 3,
            prescan_fov_vox=[SPAT] * 3, slice_fov_mm=[48.0, 48.0, 1.5],
            slice_fov_vox=[SPAT, SPAT, 1], num_sa_slices=3, use_caching=False)


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def to_flax(state_dict):
    """The port's SegUnet2D state_dict -> flax params (the inverse of
    ``convert.segunet_state_dict``)."""
    params = {}
    for key, value in state_dict.items():
        name, leaf = key.rsplit('.', 1)
        v = value.numpy()
        if name.endswith('_norm'):
            params.setdefault(name, {})['scale' if leaf == 'weight' else 'bias'] = v
        elif leaf == 'bias':
            params.setdefault(name, {})['bias'] = v
        elif name.endswith('_up'):                       # (Ci, Co, kh, kw)
            params.setdefault(name, {})['kernel'] = np.flip(v.transpose(2, 3, 0, 1), (0, 1))
        else:                                            # (Co, Ci, kh, kw)
            params.setdefault(name, {})['kernel'] = v.transpose(2, 3, 1, 0)
    return {'params': {k: {n: np.ascontiguousarray(a) for n, a in d.items()}
                       for k, d in params.items()}}


@pytest.fixture(scope='module')
def phantom_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('phantoms32')
    write_phantom_dataset(d, n_cases=6, shape=(SPAT,) * 3, n_test=2)
    return d


@pytest.fixture(scope='module')
def segmenters(phantom_dir, tmp_path_factory):
    """The training script's segmenter (reference widths, 40 steps at 32^2 with
    GIN and the low-resolution simulation), as an orbax checkpoint of its flax
    params for the JAX package and as those params converted back, saved with
    ``torch.save``, for the port."""
    tmp = tmp_path_factory.mktemp('segmenter')
    summary = train_segmenter.main([
        '--data_dir', str(phantom_dir), '--out', str(tmp / 'trained.pt'),
        '--dataset', 'synthetic', '--spat', str(SPAT), '--epochs', '2',
        '--steps_per_epoch', '20', '--batch', '8', '--multires', '--device', 'cpu',
        '--cache_dir', str(tmp / 'cache')])
    trained = torch.load(tmp / 'trained.pt', weights_only=True)
    flax_params = to_flax(trained['params'])
    jsave_checkpoint(tmp / 'orbax', {'params': flax_params, 'num_classes': 6})
    torch.save({'params': segunet_state_dict(flax_params), 'num_classes': 6},
               tmp / 'seg.pt')
    return dict(jax=str(tmp / 'orbax'), torch=str(tmp / 'seg.pt'), flax=flax_params,
                summary=summary, state=trained)


# ---------------------------------------------------------------- the network

@pytest.mark.parametrize('hw', [(32, 32), (24, 40)])
@pytest.mark.parametrize('features', [(4, 8), (8, 16, 32)])
def test_segunet_forward_matches_jax(features, hw):
    """Converted flax params, random norm scales and biases, float32: logits
    within 1e-5 of their largest magnitude."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2,) + hw + (1,)).astype(np.float32)
    jm = JSegUnet2D(num_classes=6, features=features)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    model = SegUnet2D(6, features)
    model.load_state_dict(segunet_state_dict(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2,) + hw + (6,)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_gin_with_jax_draws_matches_jax():
    """``gin_apply`` with the kernels and alpha ``gin_aug`` drew from its key."""
    x = np.random.default_rng(1).normal(size=(3, 20, 24, 1)).astype(np.float32)
    key = jax.random.key(3)
    ref = np.asarray(jgin.gin_aug(key, jnp.asarray(x)))
    keys = jax.random.split(key, 5)
    kernels, ci = [], 1
    for i in range(4):
        co = 1 if i == 3 else 2
        w = jax.random.normal(keys[i], (3, 3, ci, co)) * jnp.sqrt(2.0 / (ci * 9))
        kernels.append(torch.from_numpy(np.asarray(w).transpose(3, 2, 0, 1).copy()))
        ci = co
    alpha = torch.from_numpy(np.array(jax.random.uniform(keys[-1], (3, 1, 1, 1))))
    got = gin_apply(torch.from_numpy(x).permute(0, 3, 1, 2), kernels, alpha)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)


def test_gin_aug_keeps_the_norm_and_follows_its_generator():
    x = torch.randn(4, 1, 16, 16, generator=torch.Generator().manual_seed(0))
    a = gin_aug(x, torch.Generator().manual_seed(5))
    b = gin_aug(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, gin_aug(x, torch.Generator()
                                                            .manual_seed(6)))
    np.testing.assert_allclose(a.flatten(1).norm(dim=1), x.flatten(1).norm(dim=1),
                               rtol=1e-5)


@pytest.mark.parametrize('method', ['linear', 'nearest'])
@pytest.mark.parametrize('shapes', [
    ((3, 128, 128), (3, 32, 32)),             # shrink by 4: antialiased
    ((2, 1, 32, 32), (2, 1, 5, 5)),           # by 6 and more, odd out
    ((2, 1, 5, 7), (2, 1, 32, 32)),           # grow from odd sizes
    ((17, 23, 9), (40, 7, 13)),               # 3D, every axis its own way
    ((16, 16, 16), (64, 64, 64)),             # 3D growth by 4
    ((2, 33, 31), (2, 11, 64))])
def test_image_resize_matches_jax(shapes, method):
    shape, out = shapes
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), out, method))
    got = image_resize(torch.from_numpy(x), out, method).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize('shapes', [((128, 128, 128), (32, 32, 32)), ((9, 31, 6), (4, 64, 19))])
def test_image_resize_nearest_of_labels_is_jax_bit_equal(shapes):
    shape, out = shapes
    x = np.random.default_rng(3).integers(0, 6, size=shape).astype(np.int32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), out, 'nearest'))
    got = image_resize(torch.from_numpy(x), out, 'nearest')
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------- serving

def test_sliding_window_with_small_tiles_matches_jax():
    """Tiles of 16^2 over 40 x 48 slices (overlapping origins on both axes),
    gaussian blending and flip TTA; the port's slices go through in one batch."""
    rng = np.random.default_rng(4)
    images = rng.normal(size=(2, 40, 48)).astype(np.float32)
    jm = JSegUnet2D(num_classes=3, features=(4, 8))
    params = jm.init(jax.random.key(1), jnp.zeros((1, 16, 16, 1)))
    model = SegUnet2D(3, (4, 8))
    model.load_state_dict(segunet_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    got = tseg.sliding_window_logits_2d(model, torch.from_numpy(images)[:, None], 3,
                                        (16, 16), max_batch=7).numpy()
    cache = {}
    for i in range(2):
        ref = jseg.sliding_window_logits_2d(jm.apply, params, images[i], 3, (16, 16),
                                            predictor_cache=cache)
        assert np.abs(got[i].transpose(1, 2, 0) - ref).max() <= 1e-5 * np.abs(ref).max()
    assert tseg.compute_sliding_steps((40, 48), (16, 16)) == \
        jseg.compute_sliding_steps((40, 48), (16, 16))
    np.testing.assert_array_equal(tseg.gaussian_importance_map((16, 24)),
                                  jseg.gaussian_importance_map((16, 24)))


@pytest.mark.parametrize('spacing,permute', [
    ((1.5, 1.5, 1.5), False),       # the training grid: no respacing
    ((1.5, 3.0, 3.0), True)])       # respaced 2x in-plane, slices transposed
def test_make_segment_fn_matches_jax(segmenters, spacing, permute):
    vol = make_heart_phantom((SPAT,) * 3, seed=7)[1]
    ref = jseg.make_segment_fn(segmenters['jax'], 0, extra_permute=permute)(vol, spacing)
    got = tseg.make_segment_fn(segmenters['torch'], 0, extra_permute=permute,
                               device='cpu')(torch.from_numpy(vol), spacing)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (SPAT,) * 3
    assert (got.numpy() != ref).mean() <= 1e-3


def test_make_segment_fn_without_a_checkpoint(tmp_path, segmenters):
    """No checkpoint configured or none at the path: None. The JAX package's
    orbax directory loads (through ``engine/orbax_import.py``) the weights of the
    ``torch.save`` file made from the same params."""
    assert tseg.make_segment_fn(None, 0) is None
    assert tseg.make_segment_fn(str(tmp_path / 'missing.pt'), 0) is None
    from_orbax = tseg.load_segmenter(segmenters['jax'], 6, 'cpu')
    from_file = tseg.load_segmenter(segmenters['torch'], 6, 'cpu')
    ref = from_file.state_dict()
    assert from_orbax.state_dict().keys() == ref.keys()
    for k, v in from_orbax.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_spacing_from_matches_jax():
    aff = np.diag([1.5, 2.0, 3.0, 1.0])
    for arg in (aff, aff[None], [1.5, 2.0, 3.0], None):
        got, ref = tseg._spacing_from(arg), jseg._spacing_from(arg)
        assert (got is None and ref is None) or np.allclose(got, ref)


# ---------------------------------------------------------------- the build

def jax_register_centroids(fixed, moving, dof=6, seed=0):
    return np.asarray(jcent.register_centroids(np.asarray(fixed.cpu()),
                                               np.asarray(moving.cpu()), dof=dof,
                                               seed=seed))


@pytest.fixture(scope='module')
def seg_built(phantom_dir, segmenters):
    """The 2 test cases built from-segmented by both packages with the trained
    segmenter, the gate lowered for it, and the JAX package's centroid fits in
    the port's build."""
    over = dict(GRID, clinical_view_affine_type='from-segmented', segment_extra_permute=False,
                min_prescan_dice=0.0, max_prescan_hd95_mm=1e9)
    jds = jcache.load_or_build(JMMWHS, phantom_dir, jload_config(overrides=dict(
        over, segment_model_path=segmenters['jax'])), 'test')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbase, 'register_centroids', jax_register_centroids)
        tds = tcache.load_or_build(MMWHSDataset, phantom_dir, load_config(overrides=dict(
            over, segment_model_path=segmenters['torch'])), 'test', device='cpu')
    return jds, tds


def test_from_segmented_build_matches_jax(seg_built):
    """Prescan segmentations (at most 1e-5 of the voxels may differ), their
    quality (1e-6), the prescan view affines and the input view affines from them
    (1e-3), and the reoriented volumes."""
    jds, tds = seg_built
    assert sorted(tds.cases) == sorted(jds.cases) == ['mr_0005', 'mr_0006']
    for cid, ref in jds.cases.items():
        got = tds.cases[cid]
        assert set(got) == set(ref)
        assert got['prescan_label'].dtype == ref['prescan_label'].dtype
        assert (got['prescan_label'] != ref['prescan_label']).mean() <= 1e-5
        assert not np.array_equal(got['prescan_label'], got['prescan_gt'])
        for k in ('dice_mean', 'hd95_mean'):
            np.testing.assert_allclose(got['prescan_quality'][k], ref['prescan_quality'][k],
                                       atol=1e-6)
        for k in ('dice', 'hd95'):
            np.testing.assert_allclose(got['prescan_quality'][k], ref['prescan_quality'][k],
                                       atol=1e-6, equal_nan=True)
        assert set(got['prescan_view_affines']) == set(ref['prescan_view_affines'])
        for view, aff in ref['prescan_view_affines'].items():
            np.testing.assert_allclose(got['prescan_view_affines'][view], aff, atol=1e-3,
                                       err_msg=f'{cid} {view}')
        np.testing.assert_allclose(got['input_view_affines'], ref['input_view_affines'],
                                   atol=1e-3)
        assert (got['label'] != ref['label']).mean() <= 1e-5
        np.testing.assert_allclose(got['image'], ref['image'], atol=1e-3)


def test_from_segmented_build_gate_and_missing_segmenter(phantom_dir, segmenters):
    """The default gate (Dice 0.5, HD95 12 mm) fails a prescan segmented worse than
    that; a from-segmented build without a segmenter raises, for both dataset
    classes."""
    cfg = load_config(overrides=dict(GRID, clinical_view_affine_type='from-segmented',
                                     segment_extra_permute=False, min_prescan_dice=1.01,
                                     segment_model_path=segmenters['torch']))
    with pytest.raises(RuntimeError, match='build gate'):
        tcache.load_or_build(MMWHSDataset, phantom_dir, cfg, 'test', device='cpu')
    for cls in (MMWHSDataset, MRXCATDataset):
        cfg = load_config(overrides=dict(GRID, clinical_view_affine_type='from-segmented',
                                         segment_model_path=str(phantom_dir / 'none.pt')))
        with pytest.raises(RuntimeError, match='needs a segmenter'):
            tcache.load_or_build(cls, phantom_dir, cfg, 'test', device='cpu')


# ---------------------------------------------------------------- script and runner

def test_training_script_trains_and_saves(segmenters):
    s = segmenters['summary']
    assert s['steps'] == 40 and np.isfinite(s['final_loss']) and s['final_loss'] < 1.0
    state = segmenters['state']
    assert state['num_classes'] == 6
    assert state['params']['enc0a_conv.weight'].shape == (32, 1, 3, 3)
    assert state['params']['enc4a_conv.weight'].shape == (512, 256, 3, 3)


def test_sample_slices_matches_jax():
    from scripts.train_segmenter import sample_slices as jsample
    cases = {f'c{i}': dict(zip(('label', 'image'), make_heart_phantom((16,) * 3, seed=i)[:2]))
             for i in range(3)}
    ds = BaseDataset.from_cases(cases, load_config())
    for a, b in zip(train_segmenter.sample_slices(ds, np.random.default_rng(9), 6),
                    jsample(ds, np.random.default_rng(9), 6)):
        np.testing.assert_array_equal(a, b)


def test_simulate_lowres_applies_jax_resizes():
    """Each sample is the JAX package's linear-down, nearest-up pair at the zoom
    drawn for it (the draw itself is torch's)."""
    x = torch.randn(6, 1, 24, 24, generator=torch.Generator().manual_seed(1))
    zooms = (1.0, 1.0 / 2, 1.0 / 4, 1.0 / 6)
    got = train_segmenter.simulate_lowres(x, torch.Generator().manual_seed(2), zooms)
    choice = torch.randint(4, (6,), generator=torch.Generator().manual_seed(2)).tolist()
    for i, k in enumerate(choice):
        h = max(1, int(24 * zooms[k]))
        img = jnp.asarray(x[i].numpy())
        ref = jax.image.resize(jax.image.resize(img, (1, h, h), 'linear'), (1, 24, 24),
                               'nearest')
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), atol=1e-6)
    assert len(set(choice)) > 1


def test_load_segmenter_warns_for_a_missing_checkpoint(tmp_path, capsys, segmenters):
    """A from-segmented run whose checkpoint is missing goes on without a
    segmenter, with a warning, as the JAX runner does; a present one loads."""
    cfg = dict(label_slice_type='from-segmented', segment_model_path=str(tmp_path / 'x.pt'))
    assert trunner._load_segmenter(cfg, 6, 'cpu') is None
    assert 'no checkpoint at' in capsys.readouterr().out
    assert trunner._load_segmenter(dict(cfg, label_slice_type='from-gt'), 6, 'cpu') is None
    seg = trunner._load_segmenter(dict(cfg, segment_model_path=segmenters['torch']), 6, 'cpu')
    assert isinstance(seg, SegUnet2D) and not seg.training
    assert not any(p.requires_grad for p in seg.parameters())
