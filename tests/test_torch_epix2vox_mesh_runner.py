"""(E)Pix2Vox through the port's runner and CLI on a device mesh, on the CPU:
gloo ranks (one intra-op thread each) whose rank functions live in
``torch_mesh_workers.py``.

* ``run_dl`` of hybrid-EPix2Vox (2 views, binarized labels, the localization nets
  training) under {'data': 2} for one epoch at the model's fixed 128^3 against
  ``run_dl`` in one process: loss tracks within the JAX package's 2e-3 (first
  train loss 1e-3), and each run's checkpoint resumed in the other setting for
  the second epoch, the two continuations again within 2e-3 of each other. The
  validation batch (``val_batch_size=1``) runs replicated on both ranks. The
  checkpoints are one-device files with both Adam groups; each run writes only
  its pause (~1 GB, as every (E)Pix2Vox checkpoint), and the files go when the
  tests are done.
* The CLI: ``main.main`` with a config like ``config_dict_id21.json`` and
  ``mesh_shape`` {'data': 2} under ``--device cpu`` builds the dataset from NIfTI
  files, starts two gloo ranks and runs the ref stage; its checkpoint loads into
  a one-process model.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from acquisition_focus_tpu_torch import main as tmain
from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
from acquisition_focus_tpu_torch.data.phantom import phantom_cases
from acquisition_focus_tpu_torch.data.synthetic import write_phantom_dataset
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.checkpoint import load_checkpoint
from acquisition_focus_tpu_torch.engine.config import load_config
from acquisition_focus_tpu_torch.parallel.mesh import join_ranks, spawn_ranks

import torch_mesh_workers as workers
from test_torch_mesh import loss_track

RUN = dict(
    base_views=['p2CH', 'p4CH'], model_type='hybrid-EPix2Vox', use_binarized_labels=True,
    view_optimization_mode='opt-all', use_affine_theta=True, sweep_type=None,
    hires_fov_mm=[192.0] * 3, hires_fov_vox=[128] * 3, slice_fov_mm=[192.0, 192.0, 1.5],
    slice_fov_vox=[128, 128, 1], prescan_fov_mm=[192.0] * 3, prescan_fov_vox=[32] * 3,
    locnet_width=2, batch_size=2, num_grad_accum_steps=1, val_batch_size=1,
    metrics_every=1000, do_output=False, save_every=None, use_caching=False, epochs=2,
    stop_at_epoch=1)
FOLD = (0, ([0, 1], [2]))


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def binarized_cases(n, first_seed=0):
    cases = phantom_cases(n, (128,) * 3, (1.5,) * 3, 2, first_seed)
    for case in cases.values():
        case['label'] = (case['label'] > 0).astype(np.int32)
    return cases


def run_config(tmp, **overrides):
    return load_config(overrides=dict(RUN, log_dir=str(tmp / 'runs'),
                                      mdl_save_prefix=str(tmp / 'models'), **overrides))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Epoch 0 under {'data': 2} on two ranks and in this process side by side,
    each paused after it (``stop_at_epoch``: one ~1 GB checkpoint, removed after
    the tests); then epoch 1 of each from the other's pause."""
    tmp = tmp_path_factory.mktemp('epix_runs')
    cfg = load_config(overrides=RUN)
    datasets = (BaseDataset.from_cases(binarized_cases(3), cfg),
                BaseDataset.from_cases(binarized_cases(1, 100), cfg, 'test'))
    mesh_cfg = run_config(tmp, mesh_shape={'data': 2})
    single_ckpt = tmp / 'models' / 'single_pause'
    jobs = [('run', str(tmp), mesh_cfg, FOLD, datasets, 'mesh'),
            ('wait_for', str(single_ckpt)),
            ('run', str(tmp), dict(mesh_cfg, stop_at_epoch=None,
                                   model_checkpoint_path=str(single_ckpt)),
             FOLD, datasets, 'mesh_resumed')]
    running = spawn_ranks(workers.world, 2, args=(jobs, str(tmp / 'w2')), threads=1,
                          join=False)
    workers.run(str(tmp), run_config(tmp), FOLD, datasets, 'single')
    join_ranks(running)
    workers.run(str(tmp), run_config(tmp, stop_at_epoch=None, model_checkpoint_path=str(
        tmp / 'models' / 'mesh_pause')), FOLD, datasets, 'single_resumed')
    yield tmp
    shutil.rmtree(tmp / 'models')


def test_run_dl_data_parallel_matches_one_process(runs):
    single, mesh = loss_track(runs, 'single'), loss_track(runs, 'mesh')
    assert single.keys() == mesh.keys() and len(single) == 3
    first = min(single)
    assert abs(single[first] - mesh[first]) < 1e-3
    for key, v in single.items():
        assert np.isfinite(v) and abs(v - mesh[key]) < 2e-3, (key, v, mesh[key])
    a, b = loss_track(runs, 'mesh_resumed'), loss_track(runs, 'single_resumed')
    assert a.keys() == b.keys() and {s for s, _ in a} == {max(s for s, _ in single) + 1}
    for key, v in a.items():
        assert np.isfinite(v) and abs(v - b[key]) < 2e-3, (key, v, b[key])


def test_mesh_checkpoints_are_one_device_files(runs):
    """Rank 0 alone writes each checkpoint, in the one-device format: every tensor
    at its full shape, Adam's two param groups and their rates."""
    files = sorted(p.name for p in (runs / 'models').iterdir())
    assert files == ['mesh_pause', 'single_pause']
    a, b = (load_checkpoint(runs / 'models' / f'{r}_pause') for r in ('single', 'mesh'))
    for key in ('unet', 'atms'):
        assert {k: v.shape for k, v in a[key].items()} == \
            {k: v.shape for k, v in b[key].items()}
    for ck in (a, b):
        groups = ck['recon_opt']['param_groups']
        assert [g['lr'] for g in groups] == [1e-3, 1e-4]
        assert len(groups[0]['params']) + len(groups[1]['params']) == len(ck['unet'])
    assert {i: s['exp_avg'].shape for i, s in a['recon_opt']['state'].items()} == \
        {i: s['exp_avg'].shape for i, s in b['recon_opt']['state'].items()}


def test_cli_runs_an_epix2vox_mesh_on_the_cpu(tmp_path):
    """``main([...], device='cpu')`` with a config like ``config_dict_id21.json`` and
    ``mesh_shape`` {'data': 2}: the CLI builds the dataset once and starts two
    gloo ranks; rank 0 writes the sweep state, the metrics and a checkpoint that
    loads into a one-process (E)Pix2Vox model."""
    write_phantom_dataset(tmp_path / 'data', n_cases=4, shape=(128,) * 3, n_test=1)
    meta = dict(
        model_type='hybrid-EPix2Vox', base_views=['p2CH', 'p4CH'],
        use_binarized_labels=True, stage_override='ref', fold_override=0,
        use_caching=False, epochs=1, batch_size=2, num_grad_accum_steps=1,
        prescan_fov_vox=[32] * 3, locnet_width=2, do_output=False,
        mesh_shape={'data': 2}, dataset=['synthetic', str(tmp_path / 'data')],
        sweep_state_path=str(tmp_path / 'sweep_state.json'),
        log_dir=str(tmp_path / 'runs'), mdl_save_prefix=str(tmp_path / 'models'))
    (tmp_path / 'meta.json').write_text(json.dumps(meta))
    tmain.main(['--meta_config_path', str(tmp_path / 'meta.json'),
                '--base_dir', str(tmp_path)], device='cpu')
    state = json.loads((tmp_path / 'sweep_state.json').read_text())
    assert list(state['completed']) == ['fold-0/ref']
    rec = state['completed']['fold-0/ref']
    spec = ttrain.StageSpec(n_views=2, num_classes=2, n_active_views=2,
                            view_optimization_mode='opt-none', use_affine_theta=False,
                            use_binarized_labels=True, prescan_fov_vox=(32,) * 3,
                            locnet_width=2, model_type='hybrid-EPix2Vox')
    unet, atms = ttrain.make_models(spec, 'cpu')
    ck = load_checkpoint(rec['save_path'])
    unet.load_state_dict(ck['unet'])
    atms.load_state_dict(ck['atms'])
    shutil.rmtree(tmp_path / 'models')     # ~1 GB
    lines = (Path(tmp_path) / 'runs' / rec['run_name'] / 'metrics.jsonl') \
        .read_text().splitlines()
    losses = [v for r in map(json.loads, lines) for k, v in r.items()
              if k.startswith('losses/')]
    assert losses and np.isfinite(losses).all()
