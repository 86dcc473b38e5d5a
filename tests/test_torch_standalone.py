"""The port stands alone and runs on the card unless asked for the CPU.

The port keeps its own copies of the JAX package's plain-Python modules
(``engine/config.py``, ``engine/stages.py``, ``utils/logging.py``,
``utils/visualize.py``, ``data/synthetic.py``, ``data/cache.py``,
``data/nifti_io.py``, ``utils/results.py``) instead of importing them; the tests
here and in ``test_torch_dataset.py`` / ``test_torch_cli.py`` hold each copy equal
to its original, and show in a subprocess that no module of the port imports
anything of the JAX package.
"""

import importlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from acquisition_focus_tpu.data import cache as jcache
from acquisition_focus_tpu.data.synthetic import make_heart_phantom as jphantom
from acquisition_focus_tpu.engine import config as jconfig
from acquisition_focus_tpu.engine import stages as jstages
from acquisition_focus_tpu.utils import logging as jlogging
from acquisition_focus_tpu_torch.data import cache as tcache
from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
from acquisition_focus_tpu_torch.data.mmwhs import MMWHSDataset
from acquisition_focus_tpu_torch.data.nifti_io import save_nifti
from acquisition_focus_tpu_torch.data.phantom import phantom_cases
from acquisition_focus_tpu_torch.data.synthetic import make_heart_phantom as tphantom
from acquisition_focus_tpu_torch.data.synthetic import write_phantom_dataset
from acquisition_focus_tpu_torch.engine import config as tconfig
from acquisition_focus_tpu_torch.engine import stages as tstages
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.runner import run_dl
from acquisition_focus_tpu_torch import main as tmain
from acquisition_focus_tpu_torch.main import stage_sweep_run
from acquisition_focus_tpu_torch.utils import logging as tlogging

STANDALONE = r'''
import importlib, pkgutil, sys

class Blocked:
    """Refuses every import of the JAX package."""
    def find_spec(self, name, path=None, target=None):
        if name == 'acquisition_focus_tpu' or name.startswith('acquisition_focus_tpu.'):
            raise ImportError(f'the port imported {name}')
        return None

sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
import acquisition_focus_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
    importlib.import_module(m.name)

from acquisition_focus_tpu_torch.engine import train
from acquisition_focus_tpu_torch.engine.optimizers import (
    make_reconstruction_optimizer, make_transform_optimizer)
spec = train.StageSpec(
    n_views=2, num_classes=3, n_active_views=2, view_optimization_mode='opt-all',
    use_affine_theta=True, hires_fov_mm=(24.0,) * 3, hires_fov_vox=(16,) * 3,
    slice_fov_mm=(24.0, 24.0, 1.5), slice_fov_vox=(16, 16, 1),
    prescan_fov_mm=(24.0,) * 3, prescan_fov_vox=(32,) * 3, num_grad_accum_steps=1,
    compute_dtype='float32', augment_input=False, base_features=(2, 4, 4, 8),
    locnet_width=2)
unet, atms = train.make_models(spec, 'cpu')
train.init_params(unet, atms, torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
batch = {'label': torch.tensor(rng.integers(0, 3, (1, 1, 16, 16, 16))),
         'nii_affine': torch.tensor(np.diag([1.5, 1.5, 1.5, 1.0]), dtype=torch.float32
                                    ).expand(1, 1, 4, 4),
         'view_affines': torch.eye(4).expand(1, 2, 1, 4, 4)}
out = train.train_step(spec, unet, atms,
                       make_reconstruction_optimizer(unet.parameters(), 1e-3, 1),
                       make_transform_optimizer(atms.parameters(), 1e-3, 2, 1), batch)
assert np.isfinite(float(out['loss']))
from acquisition_focus_tpu_torch.engine.optimizers import make_epix2vox_optimizer
from acquisition_focus_tpu_torch.models.epix2vox import epix2vox_interface_input
import dataclasses
epix, _ = train.make_models(dataclasses.replace(spec, model_type='hybrid-EPix2Vox'), 'cpu')
train.init_params(epix, atms, torch.Generator().manual_seed(0))
make_epix2vox_optimizer(epix, 1)
with torch.no_grad():
    occ = epix(epix2vox_interface_input(torch.rand(1, 4, 16, 16), 2))
assert occ.shape == (1, 128, 128, 128) and torch.isfinite(occ).all()
import torch.distributed as dist
from acquisition_focus_tpu_torch import parallel
from acquisition_focus_tpu_torch.parallel.mesh import free_port, make_mesh
assert make_mesh(None) is None
dist.init_process_group('gloo', init_method=f'tcp://localhost:{free_port()}', rank=0,
                        world_size=1)
mesh = make_mesh({'model': 1})
unet, atms = train.make_models(spec, 'cpu')
train.init_params(unet, atms, torch.Generator().manual_seed(0))
parallel.shard_params(unet, atms, mesh)
out = train.train_step(spec, unet, atms,
                       make_reconstruction_optimizer(unet.parameters(), 1e-3, 1),
                       make_transform_optimizer(atms.parameters(), 1e-3, 2, 1),
                       parallel.shard_batch(batch, mesh), mesh=mesh)
assert np.isfinite(float(out['loss']))
dist.destroy_process_group()
from acquisition_focus_tpu_torch.models.segmentation import SegUnet2D
seg = SegUnet2D(3, (4, 8)).eval()
onehot = train.segment_slices(spec, seg, torch.randn(2, 1, 1, 16, 16))
assert onehot.shape == (2, 1, 3, 16, 16)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('acquisition_focus_tpu', 'jax', 'flax', 'optax', 'orbax'))
assert not bad, bad
print('ok')
'''


def test_port_stands_alone_with_the_jax_package_blocked():
    """Every module of the port imports, and one skinny CPU ``train_step`` (also on
    a {'model': 1} mesh of ``acquisition_focus_tpu_torch.parallel`` in a gloo group
    of one process) and a segmenter's ``segment_slices`` run, with any import of
    ``acquisition_focus_tpu`` refused; no jax, flax, optax or orbax module is
    loaded."""
    torch_threads = 'import torch; torch.set_num_threads(2)\n'
    out = subprocess.run([sys.executable, '-c', torch_threads + STANDALONE],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith('ok'), out.stderr[-3000:]


# ---------------------------------------------------------------- copies vs originals

def test_config_copy_matches():
    assert tconfig.DEFAULTS == jconfig.DEFAULTS
    over = dict(epochs=3, use_pallas_conv3d='full', theta_refresh_every=2)
    t, j = tconfig.load_config(overrides=over), jconfig.load_config(overrides=over)
    assert t == j and isinstance(t, tconfig.DotDict) and t.epochs == 3


@pytest.mark.parametrize('overrides', [{}, dict(theta_refresh_every=2)])
def test_stages_copy_matches(overrides):
    """Each stage's merged config, with the runner's ``save_path`` write-back that
    chains the stages, equal in the copy and the original."""
    merged = {}
    for name, conf, st in (('torch', tconfig, tstages), ('jax', jconfig, jstages)):
        config = conf.load_config(overrides=overrides)
        sweep = st.get_std_stages(config)
        merged[name] = []
        for i, stage in enumerate(sweep):
            stage.activate()
            merged[name].append((sweep.current_key,
                                 dict(st.merge_stage_config(conf.DotDict(config.copy()),
                                                            stage))))
            stage['save_path'] = f'models/stage{i}_best'
    assert merged['torch'] == merged['jax']
    assert [k for k, _ in merged['torch']] == ['opt_view0', 'opt_view1', 'opt_view2', 'ref']
    assert merged['torch'][1][1]['transform_model_checkpoint_path'] == 'models/stage0_best'


@pytest.mark.parametrize('seed', [0, 1])
def test_phantom_copy_is_bit_equal(seed):
    t = tphantom(shape=(24, 20, 16), seed=seed, spacing=(1.5, 2.0, 1.0))
    j = jphantom(shape=(24, 20, 16), seed=seed, spacing=(1.5, 2.0, 1.0))
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize('state', ['train', 'test'])
def test_cache_key_matches(tmp_path, state):
    (tmp_path / 'metadata').mkdir()
    (tmp_path / 'metadata' / 'data_split.json').write_text('{"train_files": ["a"]}')
    for over in ({}, dict(hires_fov_vox=[64] * 3, seed=3)):
        cfg = tconfig.load_config(overrides=over)
        assert tcache._fingerprint(tmp_path, cfg, state) == \
            jcache._fingerprint(tmp_path, cfg, state)
    assert tcache._CACHE_KEYS == jcache._CACHE_KEYS


def test_cache_written_by_jax_loads_through_the_copy(tmp_path):
    cases = phantom_cases(2, (8,) * 3, (1.5,) * 3, 2)

    class Built(BaseDataset):
        def _load(self):
            self.cases = dict(cases)

    (tmp_path / 'metadata').mkdir()
    (tmp_path / 'metadata' / 'data_split.json').write_text('{"train_files": []}')
    cfg = tconfig.load_config(overrides=dict(use_caching=True))
    jcache.load_or_build(Built, tmp_path, cfg, 'train', cache_dir=tmp_path / 'cache')
    Loaded = type('Built', (BaseDataset,), {})     # same name: same cache file
    ds = tcache.load_or_build(Loaded, tmp_path, cfg, 'train', cache_dir=tmp_path / 'cache')
    assert type(ds) is Loaded and sorted(ds.cases) == sorted(cases)
    for cid, case in cases.items():
        for k, v in case.items():
            np.testing.assert_array_equal(ds.cases[cid][k], v)


def test_run_logger_copy_writes_the_same_lines(tmp_path, monkeypatch):
    monkeypatch.setattr(time, 'time', lambda: 1234.5)
    per_label = {'dice': {'LV': 0.5, 'RV': 0.25}, 'iou': {'LV': 0.125}}
    for name, mod in (('torch', tlogging), ('jax', jlogging)):
        log = mod.RunLogger(tmp_path / name, 'run', config={'epochs': 2, 'lr': 1e-3})
        step = mod.get_global_idx(1, 3, 80)
        log.log({'losses/train_loss': 0.75}, step=step)
        log.log_label_metrics('scores/val_mean', per_label, step, selected=('dice',))
        log.log_oa_metrics('scores/val_mean_oa_exclude_bg', {'dice': 0.375}, step)
        log.finish()
    for f in ('metrics.jsonl', 'config.json'):
        assert (tmp_path / 'torch' / 'run' / f).read_bytes() == \
            (tmp_path / 'jax' / 'run' / f).read_bytes()
    lines = (tmp_path / 'torch' / 'run' / 'metrics.jsonl').read_text().splitlines()
    assert json.loads(lines[0]) == {'step': 100003, 'time': 1234.5, 'losses/train_loss': 0.75}


def test_visualize_copy_matches():
    from acquisition_focus_tpu.utils.visualize import slice_input_mosaic as jmosaic
    from acquisition_focus_tpu_torch.utils.visualize import slice_input_mosaic
    x = np.random.default_rng(0).normal(size=(3, 2 * 4, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(slice_input_mosaic(x, 2), jmosaic(x, 2))


# ---------------------------------------------------------------- the card by default

TINY = dict(base_views=['p2CH', 'p2CH'], hires_fov_mm=[24.0] * 3, hires_fov_vox=[16] * 3,
            slice_fov_mm=[24.0, 24.0, 1.5], slice_fov_vox=[16, 16, 1],
            prescan_fov_mm=[24.0] * 3, prescan_fov_vox=[32] * 3, compute_dtype='float32',
            base_features=[2, 4, 4, 8], locnet_width=2, stop_at_epoch=0,
            save_every=None, use_caching=False)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


BUILD = dict(TINY, hires_fov_mm=[48.0] * 3, hires_fov_vox=[32] * 3,
             prescan_fov_mm=[48.0] * 3, prescan_fov_vox=[32] * 3, num_sa_slices=3)


@pytest.mark.parametrize('entry', ['make_models', 'run_dl', 'stage_sweep_run',
                                   'BaseDataset', 'load_or_build', 'main',
                                   'preprocess_mmwhs', 'preprocess_mrxcat',
                                   'make_models_epix2vox', 'train_phantom_e2e'])
def test_entry_points_default_to_the_card(no_cuda, tmp_path, monkeypatch, entry):
    """Without CUDA each entry point raises unless the caller passes
    ``device='cpu'`` (the preprocess CLIs: ``--device cpu``); with it, the CPU
    run goes through (no epoch here)."""
    cfg = tconfig.load_config(overrides=dict(TINY, log_dir=str(tmp_path / 'runs'),
                                             mdl_save_prefix=str(tmp_path / 'models')))
    ds = BaseDataset.from_cases(phantom_cases(1, (16,) * 3, (1.5,) * 3, 2), cfg)
    fold = (0, ([0], []))
    data = tmp_path / 'data'
    build_cfg = tconfig.load_config(overrides=dict(
        BUILD, dataset=['synthetic', str(data)], log_dir=str(tmp_path / 'runs'),
        mdl_save_prefix=str(tmp_path / 'models')))
    if entry in ('BaseDataset', 'load_or_build', 'main', 'train_phantom_e2e'):
        write_phantom_dataset(data, n_cases=3, shape=(32,) * 3)
    if entry in ('make_models', 'make_models_epix2vox'):
        spec = ttrain.StageSpec(n_views=2, num_classes=6, n_active_views=2,
                                view_optimization_mode='opt-all', use_affine_theta=True,
                                hires_fov_vox=(16,) * 3, prescan_fov_vox=(32,) * 3,
                                base_features=(2, 4, 4, 8), locnet_width=2,
                                model_type='hybrid-EPix2Vox'
                                if entry == 'make_models_epix2vox' else 'hybrid-unet')

        def call(**kw):
            unet, _ = ttrain.make_models(spec, **kw)
            return next(unet.parameters()).device
    elif entry == 'run_dl':
        def call(**kw):
            return run_dl(str(tmp_path), cfg, fold, training_dataset=ds, **kw)
    elif entry == 'stage_sweep_run':
        def call(**kw):
            return stage_sweep_run(str(tmp_path), 'sw', cfg, fold,
                                   tstages.get_std_stages(cfg), ds, None, False, **kw)
    elif entry == 'BaseDataset':
        def call(**kw):
            return sorted(MMWHSDataset(data, build_cfg, state='test', **kw).cases)
    elif entry == 'load_or_build':
        def call(**kw):
            return sorted(tcache.load_or_build(MMWHSDataset, data, build_cfg, 'test',
                                               **kw).cases)
    elif entry == 'train_phantom_e2e':
        from acquisition_focus_tpu_torch.scripts import train_phantom_e2e
        monkeypatch.chdir(tmp_path)             # the dataset cache goes to ./.cache

        def call(**kw):
            summary = train_phantom_e2e.run(
                epochs=0, spat=32, data_dir=data, out_dir=tmp_path / 'out',
                run_dir=tmp_path / 'e2e', single_stage=True, **kw)
            return {stage: s['epochs'] for stage, s in summary['stages'].items()}
    elif entry == 'main':
        meta = tmp_path / 'meta.json'
        meta.write_text(json.dumps(dict(build_cfg, num_folds=0, sweep_type=None)))

        def call(**kw):
            return tmain.main(['--meta_config_path', str(meta), '--base_dir',
                               str(tmp_path)], **kw)
    else:
        module = importlib.import_module(f'acquisition_focus_tpu_torch.scripts.{entry}')
        raw = tmp_path / 'raw'
        raw.mkdir()
        lbl = np.zeros((12,) * 3, np.int16)
        lbl[4:8, 4:8, 4:8] = 500 if entry == 'preprocess_mmwhs' else 5
        stem = 'mr_train_1001' if entry == 'preprocess_mmwhs' else 'phantom_001_t001'
        save_nifti(raw / f'{stem}_image.nii.gz', lbl.astype(np.float32), np.eye(4))
        save_nifti(raw / f'{stem}_label.nii.gz', lbl, np.eye(4))

        def call(device=None):
            argv = ['--raw_dir', str(raw), '--out_dir', str(tmp_path / 'out')]
            return module.main(argv + (['--device', device] if device else []))
    want = {'make_models': torch.device('cpu'), 'make_models_epix2vox': torch.device('cpu'),
            'train_phantom_e2e': {'main': 0},
            'BaseDataset': ['mr_0002', 'mr_0003'],
            'load_or_build': ['mr_0002', 'mr_0003']}.get(entry)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(device='cuda')
    assert call(device='cpu') == want
