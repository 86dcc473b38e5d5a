"""The port's CLI (``acquisition_focus_tpu_torch/main.py``) and run summaries
(``utils/results.py``) on the CPU: fold construction against the JAX package's,
``main()`` end to end on a phantom dataset written to disk, the result tables, and
every shipped meta config building its stages' models (the (E)Pix2Vox configs
included; the from-segmented ones also load a tiny segmenter and segment slices
with it).
"""

import glob
import json
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from acquisition_focus_tpu.data.mmwhs import MMWHSDataset as JMMWHS
from acquisition_focus_tpu.data.mrxcat import MRXCATDataset as JMRXCAT
from acquisition_focus_tpu.engine.config import load_config as jload_config
from acquisition_focus_tpu.utils import results as jresults
from main import build_fold_iter as jbuild_fold_iter
from acquisition_focus_tpu_torch import main as tmain
from acquisition_focus_tpu_torch.data.mmwhs import MMWHSDataset
from acquisition_focus_tpu_torch.data.mrxcat import MRXCATDataset
from acquisition_focus_tpu_torch.data.synthetic import write_phantom_dataset
from acquisition_focus_tpu_torch.engine.config import load_config
from acquisition_focus_tpu_torch.engine.runner import spec_from_config
from acquisition_focus_tpu_torch.engine.stages import get_std_stages, merge_stage_config
from acquisition_focus_tpu_torch.engine.train import make_models
from acquisition_focus_tpu_torch.utils import results as tresults

REPO = Path(__file__).resolve().parent.parent
TAGS = ('MYO', 'LV', 'RV', 'LA', 'RA')


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Many small ops: with several test workers on one machine, one intra-op
    thread per core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- folds

def _split_dataset(cls, tmp_path, files):
    (tmp_path / 'metadata').mkdir(parents=True, exist_ok=True)
    train, test = files[:-4], files[-4:]
    from acquisition_focus_tpu_torch.data.preprocess import write_data_split
    write_data_split(tmp_path, train, test, num_folds=3)
    ds = cls(tmp_path, load_config(), state='empty')
    ds.cases = {ds.extract_3d_id(cls.get_file_id(f)[0]): None for f in train}
    return ds


@pytest.mark.parametrize('family', ['mmwhs', 'mrxcat'])
@pytest.mark.parametrize('over', [dict(fold_override=None), dict(fold_override=1),
                                  dict(num_folds=0)])
def test_build_fold_iter_matches_jax(tmp_path, family, over):
    if family == 'mmwhs':
        files = [f'mr_train_{i:04d}_{k}.nii.gz' for i in range(1001, 1012)
                 for k in ('image', 'label')]
        tcls, jcls = MMWHSDataset, JMMWHS
    else:
        files = [f'phantom_{p:03d}_t{t:03d}_{k}.nii.gz' for p in range(1, 4)
                 for t in range(1, 4) for k in ('image', 'label')]
        tcls, jcls = MRXCATDataset, JMRXCAT
    tds = _split_dataset(tcls, tmp_path, files)
    jds = jcls(tmp_path, jload_config(), state='empty')
    jds.cases = dict(tds.cases)
    config = dict(load_config(), **over)
    got = tmain.build_fold_iter(config, tds)
    assert got == jbuild_fold_iter(config, jds)
    assert len(got) == (1 if over.get('fold_override') is not None or
                        over.get('num_folds') == 0 else 3)


# ---------------------------------------------------------------- main()

def test_main_runs_the_stage_sweep_from_nifti_files(tmp_path):
    """``main([...], device='cpu')`` on a 6-case 32^3 phantom dataset at skinny
    widths: both datasets built from the files, fold 0, one epoch per stage; every
    stage completes, chains its transform checkpoint and writes its metrics."""
    write_phantom_dataset(tmp_path / 'data', n_cases=6, shape=(32,) * 3)
    meta = dict(
        dataset=['synthetic', str(tmp_path / 'data')], fold_override=0, use_caching=False,
        epochs=1, hires_fov_mm=[48.0] * 3, hires_fov_vox=[32] * 3,
        prescan_fov_mm=[48.0] * 3, prescan_fov_vox=[32] * 3,
        slice_fov_mm=[48.0, 48.0, 1.5], slice_fov_vox=[32, 32, 1],
        base_features=[2, 4, 4, 8], locnet_width=2, batch_size=1,
        num_grad_accum_steps=2, compute_dtype='float32', base_views=['p2CH', 'p4CH'],
        num_sa_slices=3, sweep_state_path=str(tmp_path / 'sweep_state.json'),
        log_dir=str(tmp_path / 'runs'), mdl_save_prefix=str(tmp_path / 'models'),
        do_output=False)
    (tmp_path / 'meta.json').write_text(json.dumps(meta))
    tmain.main(['--meta_config_path', str(tmp_path / 'meta.json'),
                '--base_dir', str(tmp_path)], device='cpu')

    state = json.loads((tmp_path / 'sweep_state.json').read_text())
    keys = list(state['completed'])
    assert keys == ['fold-0/opt_view0', 'fold-0/opt_view1', 'fold-0/ref']
    assert state['in_progress'] is None
    first = state['completed'][keys[0]]
    assert first['run_name'].endswith('_cpu_fold-0_stage-opt_view0')
    assert state['completed'][keys[1]]['transform_model_checkpoint_path'] == \
        first['save_path']
    for rec in state['completed'].values():
        assert Path(rec['save_path']).exists()
        lines = [json.loads(line) for line in
                 (tmp_path / 'runs' / rec['run_name'] / 'metrics.jsonl').read_text()
                 .splitlines()]
        losses = [v for r in lines for k, v in r.items() if k.startswith('losses/')]
        assert losses and np.isfinite(losses).all()
        assert any('scores/test_mean_oa_exclude_bg_dice' in r for r in lines)


# ---------------------------------------------------------------- results

def _write_run(log_dir, name, dice_by_tag, oa, steps=(10, 20)):
    run = log_dir / name
    run.mkdir(parents=True)
    with open(run / 'metrics.jsonl', 'w') as f:
        for s in steps:
            rec = {'step': s, 'losses/train_loss': 1.0 / s}
            scale = 1.0 if s == steps[-1] else 0.01
            for t, v in dice_by_tag.items():
                rec[f'scores/test_mean_dice_{t}'] = v * scale
            rec['scores/test_mean_oa_exclude_bg_dice'] = oa * scale
            f.write(json.dumps(rec) + '\n')


def test_results_tables_match_jax(tmp_path):
    for fold in range(3):
        _write_run(tmp_path, f'run_fold-{fold}_stage-opt_view0',
                   {t: 0.4 + 0.1 * fold for t in TAGS}, oa=0.4 + 0.1 * fold)
        _write_run(tmp_path, f'run_fold-{fold}_stage-ref', {t: 0.7 for t in TAGS}, oa=0.7)
    _write_run(tmp_path, 'plain_fold-0', {t: 0.3 for t in TAGS}, oa=0.3)
    table = tresults.dice_table(tmp_path)
    assert list(table.columns) == list(TAGS) + ['overall']
    pd.testing.assert_frame_equal(table, jresults.dice_table(tmp_path))
    mean, std = tresults.cross_fold_table(tmp_path)
    jmean, jstd = jresults.cross_fold_table(tmp_path)
    pd.testing.assert_frame_equal(mean, jmean)
    pd.testing.assert_frame_equal(std, jstd)
    assert set(mean.index) == {'opt_view0', 'ref', 'main'}
    assert np.allclose(mean.loc['opt_view0'], 0.5)
    assert np.allclose(std.loc['opt_view0', 'MYO'], np.std([0.4, 0.5, 0.6]))
    run = tmp_path / 'run_fold-0_stage-ref'
    pd.testing.assert_frame_equal(tresults.load_run_metrics(run),
                                  jresults.load_run_metrics(run))


def test_results_of_an_empty_log_dir(tmp_path):
    assert tresults.summarize_runs(tmp_path).empty
    mean, std = tresults.cross_fold_table(tmp_path)
    assert mean.empty and std.empty


# ---------------------------------------------------------------- shipped configs

def _configs():
    return sorted(glob.glob(str(REPO / 'meta_configs' / 'meta_configs_*' /
                                'config_dict_id*.json')))


def _from_segmented(config):
    return config.get('clinical_view_affine_type') == 'from-segmented'


@pytest.fixture(scope='module')
def tiny_segmenter(tmp_path_factory):
    """A (4, 8)-wide segmenter from flax's init, converted and saved as the port's
    ``torch.save`` checkpoint."""
    import jax
    import jax.numpy as jnp
    from acquisition_focus_tpu.models.segmentation.unet2d import SegUnet2D
    from acquisition_focus_tpu_torch.convert import segunet_state_dict
    params = jax.jit(SegUnet2D(num_classes=6, features=(4, 8)).init)(
        jax.random.key(0), jnp.zeros((1, 32, 32, 1)))
    path = tmp_path_factory.mktemp('segmenter') / 'seg.pt'
    torch.save({'params': segunet_state_dict(jax.tree_util.tree_map(np.asarray, params)),
                'num_classes': 6}, path)
    return str(path)


def _build_specs(meta_path, segmenter=None):
    """Every stage's train and test StageSpec of one config at skinny widths, and
    its models on the CPU; from-segmented configs load ``segmenter`` through the
    runner and segment random image slices of the test spec's shape with it."""
    from acquisition_focus_tpu_torch.engine.runner import _load_segmenter
    from acquisition_focus_tpu_torch.engine.train import segment_slices
    config = load_config(None, meta_path)
    config['base_features'] = [4, 4, 8, 8, 8, 8]
    config['locnet_width'] = 4
    config['segment_model_path'] = segmenter
    num_classes = 2 if config.get('use_binarized_labels') else 6
    built = 0
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # unchained opt_view stages warn
        for stage in get_std_stages(config):
            stage.activate()
            sc = merge_stage_config(config, stage)
            n_active = int(sc.get('n_active_views') or len(sc['base_views']))
            train = spec_from_config(sc, num_classes, n_active, 'train')
            test = spec_from_config(sc, num_classes, n_active, 'test')
            unet, atms = make_models(train, 'cpu')
            assert len(atms) == train.n_views and train.num_classes in (2, 6)
            seg = _load_segmenter(sc, num_classes, 'cpu')
            assert (seg is not None) == _from_segmented(config)
            if seg is not None:
                sh, sw = test.slice_fov_vox[:2]
                image = torch.randn(n_active, 1, 1, sh, sw,
                                    generator=torch.Generator().manual_seed(0))
                onehot = segment_slices(test, seg, image)
                assert onehot.shape == (n_active, 1, num_classes) + test.hires_fov_vox[:2]
                assert torch.equal(onehot.sum(2), torch.ones_like(onehot.sum(2)))
            built += 1
    return built


@pytest.mark.parametrize('meta_path', _configs(), ids=lambda p: '/'.join(Path(p).parts[-2:]))
def test_every_config_builds_or_names_what_is_missing(meta_path, tiny_segmenter):
    """Every config builds its port StageSpecs and models (the (E)Pix2Vox configs
    their ``EPix2VoxModel128``); a from-segmented config also runs its segmenter
    (a tiny converted one) on slices of its shape. Nothing is missing."""
    meta = json.loads(Path(meta_path).read_text())
    assert _build_specs(meta_path, tiny_segmenter if _from_segmented(meta) else None) >= 1


def test_32_of_54_shipped_configs_build():
    """All 54 shipped configs build since the from-segmented path is ported (32
    before (E)Pix2Vox, 44 before from-segmented): 12 (E)Pix2Vox configs, 10
    from-segmented ones, and none that needs both."""
    configs = _configs()
    metas = [json.loads(Path(p).read_text()) for p in configs]
    assert len(configs) == 54
    segmented = [m for m in metas if _from_segmented(m)]
    assert len(segmented) == 10
    assert all(m.get('label_slice_type') == 'from-segmented' for m in segmented)
    epix = [m for m in metas if m.get('model_type') in ('hybrid-EPix2Vox', 'hybrid-Pix2Vox')]
    assert len(epix) == 12 and all(m.get('use_binarized_labels') for m in epix)
    assert not any(_from_segmented(m) for m in epix)


# ---------------------------------------------------------------- the run script

def test_phantom_run_script_writes_the_jax_scripts_summary(tmp_path, monkeypatch):
    """``scripts/train_phantom_e2e.py::run(..., device='cpu')``: one epoch of the
    single-stage protocol at 32^3 with skinny widths on a phantom dataset written
    to disk. It collects the metric stream and the last affines, and its
    ``summary.json`` holds what the JAX script's ``collect_artifacts`` writes from
    the same run directory, value for value, plus the port's extra keys."""
    from scripts.train_phantom_e2e import collect_artifacts as jcollect
    from acquisition_focus_tpu_torch.scripts import train_phantom_e2e
    monkeypatch.chdir(tmp_path)                 # the dataset cache goes to ./.cache
    write_phantom_dataset(tmp_path / 'data', n_cases=6, shape=(32,) * 3)
    summary = train_phantom_e2e.run(
        epochs=1, spat=32, fov_mult=4.5, data_dir=tmp_path / 'data',
        out_dir=tmp_path / 'out', run_dir=tmp_path / 'e2e', base_features=[2, 4, 4, 8],
        locnet_width=2, single_stage=True, compute_dtype='float32', batch_size=1,
        accum=1, device='cpu')
    out = tmp_path / 'out'
    assert json.loads((out / 'summary.json').read_text()) == summary
    assert (out / 'metrics_stage-main.jsonl').exists() and (out / 'affines_final.pkl').exists()
    main = summary['stages']['main']
    assert main['epochs'] == 1 and set(main['final_test_dice_per_class']) == set(TAGS)
    assert np.isfinite(main['final_train_loss']) and summary['peak_memory_bytes'] is None

    run_root = tmp_path / 'e2e' / 'out_run'
    jcollect(run_root, tmp_path / 'jax_out', summary['wall_s'])
    jsum = json.loads((tmp_path / 'jax_out' / 'summary.json').read_text())
    assert jsum['wall_s'] == summary['wall_s']
    for stage, rec in jsum['stages'].items():
        assert {k: summary['stages'][stage][k] for k in rec} == rec


@pytest.mark.parametrize('no_tf32', [False, True])
def test_phantom_run_script_tf32_flag(monkeypatch, no_tf32):
    """``--no_tf32`` turns cuDNN's TF32 off before the run; without it the script
    leaves PyTorch's default. The run itself is stubbed: only the flag is held."""
    from acquisition_focus_tpu_torch.scripts import train_phantom_e2e
    seen = {}
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    monkeypatch.setattr(train_phantom_e2e, 'run', lambda **kw: seen.update(
        kw, tf32=torch.backends.cudnn.allow_tf32))
    train_phantom_e2e.main(['--single_stage', '--device', 'cpu']
                           + (['--no_tf32'] if no_tf32 else []))
    assert seen['tf32'] is not no_tf32 and seen['single_stage'] and seen['device'] == 'cpu'
