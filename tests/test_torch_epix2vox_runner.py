"""The (E)Pix2Vox model through the port's runner (``engine/runner.py::run_dl``) on
the CPU: a 1-epoch run keeps its best-validation snapshot (the model and its Adam
state with both param groups), and a run resumed from it continues exactly as an
uninterrupted 2-epoch run does. The model's widths are fixed (128^3 out), so this
runs at full size on two in-memory phantoms, one training and one validation case.
"""

import json

import numpy as np
import pytest
import torch

from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
from acquisition_focus_tpu_torch.data.phantom import phantom_cases
from acquisition_focus_tpu_torch.engine.checkpoint import load_checkpoint
from acquisition_focus_tpu_torch.engine.runner import load_config, run_dl

RUN = dict(
    base_views=['p2CH', 'p4CH'], model_type='hybrid-EPix2Vox', use_binarized_labels=True,
    view_optimization_mode='opt-none', use_affine_theta=False, sweep_type=None,
    hires_fov_mm=[192.0] * 3, hires_fov_vox=[128] * 3, slice_fov_mm=[192.0, 192.0, 1.5],
    slice_fov_vox=[128, 128, 1], prescan_fov_mm=[192.0] * 3, prescan_fov_vox=[32] * 3,
    locnet_width=2, batch_size=1, num_grad_accum_steps=1, val_batch_size=1,
    metrics_every=1000, do_output=False, use_caching=False)


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def losses(tmp_path, run_name):
    recs = [json.loads(line) for line in
            (tmp_path / 'runs' / run_name / 'metrics.jsonl').read_text().splitlines()]
    return [(r['step'], k, v) for r in recs for k, v in r.items()
            if k.startswith('losses/')]


def test_best_snapshot_and_exact_resume(tmp_path):
    cases = phantom_cases(2, (128,) * 3, (1.5,) * 3, 2)
    for case in cases.values():
        case['label'] = (case['label'] > 0).astype(np.int32)
    cfg0 = load_config(overrides=dict(RUN, log_dir=str(tmp_path / 'runs'),
                                      mdl_save_prefix=str(tmp_path / 'models')))
    train = BaseDataset.from_cases(cases, cfg0)
    fold = (0, ([0], [1]))

    def run(name, **over):
        cfg = load_config(overrides=dict(cfg0, **over))
        return run_dl(str(tmp_path), cfg, fold, training_dataset=train, run_name=name,
                      device='cpu')

    run('full', epochs=2, save_every=None)
    best = run('part', epochs=1, save_every='best')
    assert best.endswith('part_best')
    ck = load_checkpoint(best)
    groups = ck['recon_opt']['param_groups']
    assert [g['lr'] for g in groups] == [1e-3, 1e-4]
    assert len(groups[0]['params']) + len(groups[1]['params']) == len(ck['unet'])
    assert ck['epoch'] == 0 and np.isfinite(ck['best_quality'])
    run('resumed', epochs=2, save_every=None, model_checkpoint_path=best)
    full, part, resumed = (losses(tmp_path, n) for n in ('full', 'part', 'resumed'))
    assert part == [x for x in full if x[0] == part[0][0]]
    assert resumed and resumed == [x for x in full if x[0] == resumed[0][0]]
    assert resumed[0][0] != part[0][0]
