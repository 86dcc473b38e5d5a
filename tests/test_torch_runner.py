"""The port's runner (``engine/runner.py::run_dl``, ``main.py::stage_sweep_run``) on
an in-memory phantom dataset, on the CPU in float32: exact resume, the
theta-refresh cadence, stage chaining, and the metric names it logs against the
JAX runner's. The steps it calls are held against the JAX package's in
``test_torch_runner_steps.py``.
"""

import json

import numpy as np
import pytest
import torch

from acquisition_focus_tpu.engine.runner import run_dl as jrun_dl
from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
from acquisition_focus_tpu_torch.data.phantom import phantom_cases
from acquisition_focus_tpu_torch.engine.checkpoint import load_checkpoint
from acquisition_focus_tpu_torch.engine.runner import load_config, run_dl
from acquisition_focus_tpu_torch.main import get_std_stages, stage_sweep_run


RUN = dict(
    base_views=['p2CH', 'p2CH'], view_optimization_mode='opt-all', use_affine_theta=True,
    hires_fov_mm=[24.0] * 3, hires_fov_vox=[16] * 3, slice_fov_mm=[24.0, 24.0, 1.5],
    slice_fov_vox=[16, 16, 1], prescan_fov_mm=[24.0] * 3, prescan_fov_vox=[32] * 3,
    compute_dtype='float32', base_features=[2, 4, 4, 8], locnet_width=2, batch_size=1,
    num_grad_accum_steps=1, val_batch_size=1, metrics_every=1000, do_output=False,
    save_every=1, use_caching=False)


def run_config(tmp_path, **overrides):
    return load_config(overrides=dict(RUN, log_dir=str(tmp_path / 'runs'),
                                      mdl_save_prefix=str(tmp_path / 'models'),
                                      **overrides))


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """The runs here are many small ops: with several test workers on one
    machine, torch's default of one intra-op thread per core oversubscribes the
    cores and slows them many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def datasets():
    cfg = load_config(overrides=RUN)
    train = BaseDataset.from_cases(phantom_cases(6, (16,) * 3, (1.5,) * 3, 2), cfg)
    test = BaseDataset.from_cases(phantom_cases(1, (16,) * 3, (1.5,) * 3, 2, 100), cfg,
                                  'test')
    return train, test


def states_equal(a, b):
    """Bit equality of two checkpoints' nested state."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(states_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(states_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize('stop', [2, 3])
def test_exact_resume(tmp_path, datasets, stop):
    """train(4) == train(stop, paused) + resume(4 - stop), bit for bit: params,
    both optimizers and schedules. Under theta_refresh_every=2 a resume at epoch 2
    starts with a locnet epoch, one at epoch 3 with a cached epoch, whose theta
    cache the resume must rebuild first."""
    train, _ = datasets
    fold = (0, ([0, 1, 2, 3], [4]))
    full = run_dl(str(tmp_path), run_config(tmp_path, epochs=4, theta_refresh_every=2),
                  fold, training_dataset=train, run_name='full4', device='cpu')
    paused = run_dl(str(tmp_path), run_config(tmp_path, epochs=4, theta_refresh_every=2,
                                              stop_at_epoch=stop),
                    fold, training_dataset=train, run_name='part', device='cpu')
    assert paused.endswith('part_pause')
    resumed = run_dl(str(tmp_path), run_config(tmp_path, epochs=4, theta_refresh_every=2,
                                               model_checkpoint_path=paused),
                     fold, training_dataset=train, run_name='resumed', device='cpu')
    a, b = load_checkpoint(full), load_checkpoint(resumed)
    assert a['epoch'] == b['epoch'] == 3
    for k in ('unet', 'atms', 'recon_opt', 'recon_sched', 'trans_opt', 'trans_sched'):
        assert states_equal(a[k], b[k]), k


def test_theta_cadence_freezes_atms_and_transform_schedule(tmp_path, datasets):
    """theta_refresh_every=2: the cached epoch 1 moves the U-Net but neither the
    ATMs nor the transform optimizer (its count, so its cosine schedule, advances
    in locnet epochs only: the JAX package's schedule warp, mirrored); the locnet
    epoch 2 moves both."""
    train, _ = datasets
    fold = (0, ([0, 1], [4]))
    paths = []
    for stop in (1, 2):
        cfg = run_config(tmp_path, epochs=3, theta_refresh_every=2, save_every=None,
                         stop_at_epoch=stop,
                         model_checkpoint_path=paths[-1] if paths else None)
        paths.append(run_dl(str(tmp_path), cfg, fold, training_dataset=train,
                            run_name=f'e{stop}', device='cpu'))
    a, b = load_checkpoint(paths[0]), load_checkpoint(paths[1])
    assert states_equal(a['atms'], b['atms'])
    assert not states_equal(a['unet'], b['unet'])
    assert a['trans_sched']['last_epoch'] == b['trans_sched']['last_epoch'] == 2
    assert states_equal(a['trans_opt'], b['trans_opt'])
    assert b['recon_sched']['last_epoch'] == 4


def test_theta_cadence_locnet_epoch_moves_atms(tmp_path, datasets):
    train, _ = datasets
    fold = (0, ([0, 1], [4]))
    cfg = run_config(tmp_path, epochs=3, theta_refresh_every=2, save_every=1)
    run_dl(str(tmp_path), cfg, fold, training_dataset=train, run_name='c', device='cpu')
    e1, e2 = (load_checkpoint(tmp_path / 'models' / f'c_epx{n}') for n in (1, 2))
    assert not states_equal(e1['atms'], e2['atms'])
    assert (e1['trans_sched']['last_epoch'], e2['trans_sched']['last_epoch']) == (2, 4)


def test_stage_sweep_chains_checkpoints_and_resumes(tmp_path, datasets, capsys):
    """opt_view0 -> opt_view1 -> ref on 2 views: each opt stage loads the previous
    stage's best save; the frozen view's ATM stays bit-equal to it; a relaunch with
    the same sweep state skips the completed stages and hands their saves on."""
    train, test = datasets
    state_path = tmp_path / 'sweep.json'
    cfg = run_config(tmp_path, epochs=1, save_every='best', theta_refresh_every=2,
                     sweep_state_path=str(state_path))
    fold = (0, ([0, 1], [4]))
    assert stage_sweep_run(str(tmp_path), 'sw', cfg, fold, get_std_stages(cfg), train,
                           test, False) is None
    state = json.loads(state_path.read_text())
    keys = list(state['completed'])
    assert keys == ['fold-0/opt_view0', 'fold-0/opt_view1', 'fold-0/ref']
    assert state['in_progress'] is None
    saves = [state['completed'][k]['save_path'] for k in keys]
    assert [s.rsplit('/', 1)[-1] for s in saves] == [
        'sw_stage-opt_view0_best', 'sw_stage-opt_view1_best', 'sw_stage-ref_best']
    assert state['completed'][keys[1]]['transform_model_checkpoint_path'] == saves[0]
    v0, v1 = load_checkpoint(saves[0])['atms'], load_checkpoint(saves[1])['atms']
    assert all(torch.equal(v0[n], v1[n]) for n in v0 if n.startswith('0.'))
    assert not all(torch.equal(v0[n], v1[n]) for n in v0 if n.startswith('1.'))

    capsys.readouterr()
    stage_sweep_run(str(tmp_path), 'sw', cfg, fold, get_std_stages(cfg), train, test, False)
    out = capsys.readouterr().out
    assert [f"Skipping completed stage {k} (save_path={s})" for k, s in zip(keys, saves)] \
        == [line for line in out.splitlines() if line.startswith('Skipping')]
    assert 'Running' not in out
    assert json.loads(state_path.read_text()) == state


def test_metrics_jsonl_keys_match_jax(tmp_path, datasets):
    """One epoch with the heavy metrics (the last epoch), validation and test: the
    port's metrics.jsonl has the JAX runner's records, key for key."""
    train, test = datasets
    fold = (0, ([0], [4]))
    keys = {}
    for name, fn, kw in (('jax', jrun_dl, {}), ('torch', run_dl, dict(device='cpu'))):
        # no augmentation: the JAX runner then compiles one evaluation step
        cfg = run_config(tmp_path / name, epochs=1, do_augment_input_orientation=False)
        fn(str(tmp_path / name), cfg, fold, training_dataset=train, test_dataset=test,
           run_name=name, **kw)
        with open(tmp_path / name / 'runs' / name / 'metrics.jsonl') as f:
            keys[name] = [sorted(json.loads(line)) for line in f]
    assert keys['torch'] == keys['jax']
    flat = {k for rec in keys['torch'] for k in rec}
    assert {'scores/test_mean_oa_exclude_bg_hd95', 'scores/val_mean_iou_LV',
            'perf/epoch_s', 'losses/train_loss'} <= flat


def test_dataset_cache_written_by_jax_loads(tmp_path):
    """The JAX package's ``load_or_build`` writes its pickle of numpy cases; given
    the port's dataset class, the same jax-free function reads it back into it.
    A miss needs the dataset build, which the port does not have yet."""
    from acquisition_focus_tpu.data.base_dataset import BaseDataset as JBaseDataset
    from acquisition_focus_tpu.data.cache import load_or_build

    cases = phantom_cases(2, (16,) * 3, (1.5,) * 3, 2)

    class PhantomSet(JBaseDataset):
        def _load(self):
            self.cases = dict(cases)

    (tmp_path / 'metadata').mkdir()
    (tmp_path / 'metadata' / 'data_split.json').write_text('{"train_files": []}')
    cfg = load_config(overrides=dict(RUN, use_caching=True))
    built = load_or_build(PhantomSet, tmp_path, cfg, 'train', cache_dir=tmp_path / 'cache')

    PhantomSet = type('PhantomSet', (BaseDataset,), {})
    ds = load_or_build(PhantomSet, tmp_path, cfg, 'train', cache_dir=tmp_path / 'cache')
    assert ds.get_3d_ids() == built.get_3d_ids() == sorted(cases)
    batch = ds.make_batch(ds.get_3d_ids())
    ref = built.make_batch(built.get_3d_ids())
    assert batch.keys() == ref.keys()
    for k in batch:
        np.testing.assert_array_equal(batch[k], ref[k])
    with pytest.raises(NotImplementedError):
        load_or_build(PhantomSet, tmp_path, cfg, 'test', cache_dir=tmp_path / 'cache')
