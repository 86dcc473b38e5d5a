"""The port's dataset build, dataset classes and offline preprocessing against the JAX
package's, on the CPU.

The build test writes a 4-case phantom dataset at 64^3 (1.5 mm; hires and prescan
64^3 @ 96 mm) and builds it with both packages. The centroid fit of 500 AdamW
steps does not converge, and its result follows the float rounding of every step
(``PARITY.md``), so the port's ``register_centroids`` is replaced here by the JAX
package's on the same labels: everything downstream of the centroid affine is then
compared. Tolerances, with the largest gap measured beside each: labels bit-equal;
images 2e-5 (1.17e-5: float32 sample coordinates rounded another way, times the
normalized image's steepest step of ~4 per voxel); view and input affines 1e-4
(6.9e-7); resampled and cropped preprocessing images 1e-5 (2.5e-6).
"""

import json

import numpy as np
import pytest

from acquisition_focus_tpu.data import cache as jcache
from acquisition_focus_tpu.data import native
from acquisition_focus_tpu.data import preprocess as jprep
from acquisition_focus_tpu.data.mmwhs import MMWHSDataset as JMMWHS
from acquisition_focus_tpu.data.mrxcat import MRXCATDataset as JMRXCAT
from acquisition_focus_tpu.data.nifti_io import load_nifti as jload, save_nifti as jsave
from acquisition_focus_tpu.data.synthetic import write_phantom_dataset as jwrite
from acquisition_focus_tpu.engine.config import load_config as jload_config
from acquisition_focus_tpu.geometry import centroids as jcent
from acquisition_focus_tpu_torch.data import base_dataset as tbase
from acquisition_focus_tpu_torch.data import cache as tcache
from acquisition_focus_tpu_torch.data import preprocess as tprep
from acquisition_focus_tpu_torch.data.mmwhs import MMWHSDataset
from acquisition_focus_tpu_torch.data.mrxcat import MRXCATDataset, get_dataset_class
from acquisition_focus_tpu_torch.data.nifti_io import load_nifti, save_nifti
from acquisition_focus_tpu_torch.data.synthetic import write_phantom_dataset
from acquisition_focus_tpu_torch.engine.config import load_config

GRID = dict(hires_fov_mm=[96.0] * 3, hires_fov_vox=[64] * 3, prescan_fov_mm=[96.0] * 3,
            prescan_fov_vox=[64] * 3, num_sa_slices=3, use_caching=False)
BUILDS = {
    'default': {},
    'binarized-rnd': dict(use_binarized_labels=True, base_views=['RND', 'p4CH', 'SA-1'],
                          seed=3),
}


@pytest.fixture(scope='module')
def phantom_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('phantoms64')
    write_phantom_dataset(d, n_cases=4, shape=(64,) * 3, n_test=2)
    return d


def jax_register_centroids(fixed, moving, dof=6, seed=0):
    return np.asarray(jcent.register_centroids(np.asarray(fixed.cpu()),
                                               np.asarray(moving.cpu()), dof=dof,
                                               seed=seed))


@pytest.fixture(scope='module', params=list(BUILDS))
def built(request, phantom_dir):
    cfg = load_config(overrides=dict(GRID, **BUILDS[request.param]))
    jds = JMMWHS(phantom_dir, jload_config(overrides=dict(cfg)), state='train')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbase, 'register_centroids', jax_register_centroids)
        tds = MMWHSDataset(phantom_dir, cfg, state='train', device='cpu')
    return cfg, jds, tds


def test_build_has_the_same_cases_and_keys(built):
    _, jds, tds = built
    assert sorted(tds.cases) == sorted(jds.cases) == ['mr_0001', 'mr_0002']
    for cid in jds.cases:
        assert set(tds.cases[cid]) == set(jds.cases[cid])
        for k in ('gt_view_affines', 'prescan_view_affines'):
            assert set(tds.cases[cid][k]) == set(jds.cases[cid][k])


@pytest.mark.parametrize('key', ['label', 'prescan_gt', 'prescan_label'])
def test_build_labels_bit_equal(built, key):
    _, jds, tds = built
    for cid, case in jds.cases.items():
        got = tds.cases[cid][key]
        assert got.dtype == case[key].dtype and got.shape == case[key].shape
        np.testing.assert_array_equal(got, case[key], err_msg=cid)


def test_build_images_and_affines_match(built):
    cfg, jds, tds = built
    for cid, case in jds.cases.items():
        got = tds.cases[cid]
        np.testing.assert_allclose(got['image'], case['image'], atol=2e-5)
        for k in ('gt_view_affines', 'prescan_view_affines'):
            for view, aff in case[k].items():
                np.testing.assert_allclose(got[k][view], aff, atol=1e-4,
                                           err_msg=f'{cid} {k} {view}')
        for k in ('input_view_affines', 'nii_affine', 'prescan_nii_affine',
                  'nifti_affine'):
            assert got[k].dtype == case[k].dtype
            np.testing.assert_allclose(got[k], case[k], atol=1e-4, err_msg=f'{cid} {k}')
        assert got['input_view_affines'].shape == (len(cfg['base_views']), 4, 4)


def test_build_batches_match(built):
    """``make_batch`` collates the built cases as the JAX dataset does."""
    _, jds, tds = built
    ids = jds.get_3d_ids()
    jb, tb = jds.make_batch(ids), tds.make_batch(ids)
    assert {k: v.shape for k, v in jb.items()} == {k: v.shape for k, v in tb.items()}
    np.testing.assert_array_equal(tb['label'], jb['label'])
    assert tds.label_tags == jds.label_tags


def test_cache_miss_builds_and_either_package_reads_it(phantom_dir, tmp_path):
    """A miss builds on the given device and writes the cache file; the JAX
    package's ``load_or_build`` finds the same file and reads the port's cases."""
    cfg = load_config(overrides=dict(GRID, use_caching=True))
    ds = tcache.load_or_build(MMWHSDataset, phantom_dir, cfg, 'test',
                              cache_dir=tmp_path, device='cpu')
    assert sorted(ds.cases) == ['mr_0003', 'mr_0004'] and ds.state == 'test'
    assert len(list(tmp_path.glob('MMWHSDataset_*.pkl'))) == 1
    jds = jcache.load_or_build(JMMWHS, phantom_dir, jload_config(overrides=dict(cfg)),
                               'test', cache_dir=tmp_path)
    for cid, case in ds.cases.items():
        np.testing.assert_array_equal(jds.cases[cid]['label'], case['label'])
        np.testing.assert_array_equal(jds.cases[cid]['input_view_affines'],
                                      case['input_view_affines'])


# ---------------------------------------------------------------- copies

def test_nifti_io_copy_round_trips_with_the_original(tmp_path):
    rng = np.random.default_rng(0)
    aff = np.array([[-1.2, 0.1, 0, 20], [0, 1.5, 0.2, -3], [0, 0, 0.9, 7], [0, 0, 0, 1]])
    for dtype in (np.float32, np.int16, np.uint8, np.float64):
        data = (rng.random((7, 6, 5)) * 100).astype(dtype)
        save_nifti(tmp_path / 'port.nii.gz', data, aff)
        jsave(tmp_path / 'jax.nii', data, aff)
        for path in ('port.nii.gz', 'jax.nii'):
            a, aa = load_nifti(tmp_path / path)
            b, ba = jload(tmp_path / path)
            assert a.dtype == b.dtype == dtype
            np.testing.assert_array_equal(a, data)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(aa, ba)


def test_phantom_dataset_writer_copy_matches(tmp_path):
    split_t = write_phantom_dataset(tmp_path / 't', n_cases=5, shape=(16,) * 3, seed=2)
    split_j = jwrite(tmp_path / 'j', n_cases=5, shape=(16,) * 3, seed=2)
    assert split_t == split_j
    assert (tmp_path / 't/metadata/data_split.json').read_text() == \
        (tmp_path / 'j/metadata/data_split.json').read_text()
    for name in split_t['train_files'] + split_t['test_files']:
        a, aa = load_nifti(tmp_path / 't' / name)
        b, ba = load_nifti(tmp_path / 'j' / name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(aa, ba)


# ---------------------------------------------------------------- dataset classes

class TestMRXCATIds:
    def test_file_id_regex(self):
        fid, is_label = MRXCATDataset.get_file_id("phantom_004_t002_image.nii.gz")
        assert fid == "004_t002" and not is_label
        fid, is_label = MRXCATDataset.get_file_id(
            "/some/dir/phantom_012_t010_label.nii.gz")
        assert fid == "012_t010" and is_label

    def test_3d_id_groups_by_phantom_and_frame(self):
        ds = MRXCATDataset.__new__(MRXCATDataset)
        assert ds.extract_3d_id("004_t002") == "004_t002"
        assert ds.extract_3d_id("004_t002_extra") == "004_t002"

    def test_rejects_foreign_names(self):
        with pytest.raises(IndexError):
            MRXCATDataset.get_file_id("mr_train_1001_image.nii.gz")


class TestMMWHSIds:
    def test_file_id_regex(self):
        fid, is_label = MMWHSDataset.get_file_id("mr_train_1001_image.nii.gz")
        assert fid == "mr_1001" and not is_label
        fid, is_label = MMWHSDataset.get_file_id("ct_train_1007_label.nii.gz")
        assert fid == "ct_1007" and is_label

    def test_rejects_foreign_names(self):
        with pytest.raises(IndexError):
            MMWHSDataset.get_file_id("phantom_004_t002_image.nii.gz")


@pytest.mark.parametrize('name', [
    'mr_train_1001_image.nii.gz', 'ct_train_1007_label.nii.gz',
    'phantom_004_t002_image.nii.gz', 'phantom_012_t010_label.nii.gz'])
def test_file_ids_match_jax(name):
    for tcls, jcls in ((MMWHSDataset, JMMWHS), (MRXCATDataset, JMRXCAT)):
        try:
            want = jcls.get_file_id(name)
        except IndexError:
            with pytest.raises(IndexError):
                tcls.get_file_id(name)
            continue
        assert tcls.get_file_id(name) == want


def test_registry():
    assert get_dataset_class("mrxcat") is MRXCATDataset
    assert get_dataset_class("mmwhs") is MMWHSDataset
    assert get_dataset_class("synthetic") is MMWHSDataset
    with pytest.raises(KeyError):
        get_dataset_class("nope")


def test_label_tags_default_and_binarized(phantom_dir):
    assert MRXCATDataset.label_tags == ("background", "MYO", "LV", "RV", "LA", "RA")
    assert MMWHSDataset.label_tags == MRXCATDataset.label_tags
    ds = MMWHSDataset(phantom_dir, load_config(overrides=dict(use_binarized_labels=True)),
                      state='empty')
    assert ds.label_tags == ("background", "foreground")


# ---------------------------------------------------------------- preprocessing

@pytest.fixture
def jax_op_route(monkeypatch):
    """The JAX package's ``resample_iso`` through its JAX op, the route the port
    mirrors (its optional host library is not loaded by the port)."""
    monkeypatch.setattr(native, 'is_available', lambda: False)


def test_reorient_to_lpi_bit_equal(rng):
    data = rng.random((6, 7, 8)).astype(np.float32)
    for perm, signs in (([2, 0, 1], [-1, 1, -1]), ([1, 2, 0], [1, 1, 1]),
                        ([0, 1, 2], [-1, -1, 1])):
        affine = np.zeros((4, 4))
        affine[3, 3] = 1.0
        for i, (p, s) in enumerate(zip(perm, signs)):
            affine[p, i] = s * (1.0 + 0.2 * i)
        affine[:3, 3] = [5.0, -3.0, 2.0]
        got, got_aff = tprep.reorient_to_lpi(data, affine)
        want, want_aff = jprep.reorient_to_lpi(data, affine)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_aff, want_aff)
        assert (np.diag(got_aff[:3, :3]) < 0).all()


@pytest.mark.parametrize('shape,zooms', [((10, 12, 14), (2.0, 1.0, 0.5)),
                                         ((20, 18, 16), (1.3, 0.7, 1.1))])
def test_resample_iso_matches_jax(jax_op_route, rng, shape, zooms):
    """A 2 mm -> 1 mm axis puts every other output voxel on a half-voxel tie:
    the labels stay bit-equal there too (``ops/resample.py``)."""
    affine = np.diag(list(zooms) + [1.0])
    img = rng.random(shape).astype(np.float32)
    lbl = rng.integers(0, 6, shape)
    got, got_aff = tprep.resample_iso(img, affine, 1.0, device='cpu')
    want, want_aff = jprep.resample_iso(img, affine, 1.0)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got_aff, want_aff)
    got, _ = tprep.resample_iso(lbl, affine, 1.0, is_label=True, device='cpu')
    want, _ = jprep.resample_iso(lbl, affine, 1.0, is_label=True)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_remap_labels_matches_jax():
    lbl = np.array([0, 205, 500, 600, 420, 550, 7, 1, 5, 6, 8])
    for mapping in (tprep.MMWHS_LABEL_MAP, tprep.MRXCAT_LABEL_MAP):
        np.testing.assert_array_equal(tprep.remap_labels(lbl, mapping),
                                      jprep.remap_labels(lbl, mapping))
    assert tprep.MMWHS_LABEL_MAP == jprep.MMWHS_LABEL_MAP
    assert tprep.MRXCAT_LABEL_MAP == jprep.MRXCAT_LABEL_MAP


@pytest.mark.parametrize('fov_mm,fov_vox', [((24.0,) * 3, (16,) * 3),
                                            ((30.0,) * 3, (20,) * 3)])
def test_preprocess_case_writes_the_same_files(jax_op_route, tmp_path, rng, fov_mm,
                                               fov_vox):
    lbl = np.zeros((40, 40, 40), np.int16)
    lbl[15:25, 12:22, 18:28] = 205
    lbl[20:30, 18:26, 10:20] = 500
    img = rng.random((40, 40, 40)).astype(np.float32)
    aff = np.diag([-1.2, -1.2, -1.2, 1.0])
    aff[:3, 3] = [20, 20, 20]
    save_nifti(tmp_path / 'raw_image.nii.gz', img, aff)
    save_nifti(tmp_path / 'raw_label.nii.gz', lbl, aff)
    names = []
    for out, prep, kw in (('t', tprep, dict(device='cpu')), ('j', jprep, {})):
        names.append(prep.preprocess_case(
            tmp_path / 'raw_image.nii.gz', tmp_path / 'raw_label.nii.gz', tmp_path / out,
            'mr_train_1001', fov_mm=fov_mm, fov_vox=fov_vox, **kw))
    assert names[0] == names[1]
    for name in names[0]:
        got, got_aff = load_nifti(tmp_path / 't' / name)
        want, want_aff = load_nifti(tmp_path / 'j' / name)
        assert got.dtype == want.dtype and got.shape == tuple(fov_vox)
        np.testing.assert_array_equal(got_aff, want_aff)
        if 'label' in name:
            np.testing.assert_array_equal(got, want)
            assert set(np.unique(got)) == {0, 1, 2}
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)


def test_write_data_split_matches_jax(tmp_path):
    files = [f'mr_train_{i:04d}_{k}.nii.gz' for i in range(1001, 1008)
             for k in ('image', 'label')]
    for folds in (1, 3):
        a = tprep.write_data_split(tmp_path / 't', files[:10], files[10:], folds)
        b = jprep.write_data_split(tmp_path / 'j', files[:10], files[10:], folds)
        assert a == b
        assert json.loads((tmp_path / 't/metadata/data_split.json').read_text()) == b


def test_preprocess_cli_on_raw_files(tmp_path, rng):
    """The port's MMWHS preparation CLI on synthetic raw volumes (real MMWHS files
    are not in the repository): every case prepared, the split written."""
    from acquisition_focus_tpu_torch.scripts import preprocess_mmwhs, preprocess_mrxcat
    raw = tmp_path / 'raw'
    raw.mkdir()
    aff = np.diag([1.25, 1.25, 1.25, 1.0])
    for case in (1001, 1002, 1007):
        lbl = np.zeros((24, 24, 24), np.int16)
        lbl[8:16, 6:14, 9:17] = 500
        save_nifti(raw / f'mr_train_{case}_image.nii.gz', rng.random((24,) * 3)
                   .astype(np.float32), aff)
        save_nifti(raw / f'mr_train_{case}_label.nii.gz', lbl, aff)
        save_nifti(raw / f'phantom_{case - 1000:03d}_t001_image.nii.gz',
                   rng.random((24,) * 3).astype(np.float32), aff)
        save_nifti(raw / f'phantom_{case - 1000:03d}_t001_label.nii.gz',
                   np.where(lbl > 0, 5, 0).astype(np.int16), aff)
    preprocess_mmwhs.main(['--raw_dir', str(raw), '--out_dir', str(tmp_path / 'mm'),
                           '--device', 'cpu'])
    preprocess_mrxcat.main(['--raw_dir', str(raw), '--out_dir', str(tmp_path / 'mx'),
                            '--test_phantoms', '7', '--device', 'cpu'])
    for out, n_train, n_test, want in (('mm', 2, 1, {0, 2}), ('mx', 2, 1, {0, 2})):
        split = json.loads((tmp_path / out / 'metadata/data_split.json').read_text())
        assert len(split['train_files']) == 2 * n_train
        assert len(split['test_files']) == 2 * n_test
        lbl, aff = load_nifti(tmp_path / out / split['train_files'][1])
        assert lbl.shape == (128,) * 3 and set(np.unique(lbl)) == want
        np.testing.assert_allclose(np.sqrt((aff[:3, :3] ** 2).sum(0)), 1.5, atol=1e-5)


def test_crop_case_matches_jax(rng):
    lbl = np.zeros((30, 28, 26), np.int32)
    lbl[9:20, 7:15, 5:21] = 3
    img = rng.random((30, 28, 26)).astype(np.float32)
    aff = np.diag([1.0, 1.0, 1.0, 1.0])
    got = tprep.crop_case(lbl, img, aff, (24.0,) * 3, (16,) * 3, device='cpu')
    want = jprep.crop_case(lbl, img, aff, (24.0,) * 3, (16,) * 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].dtype == np.int32
