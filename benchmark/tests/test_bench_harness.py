"""The harness on the CPU at small sizes: what a run prints, that a cell, a
configuration, a traffic mix and a metric are found as files alone, and that the
comparison rejects a broken step."""

import json
import shutil

import pytest

from benchmark import harness

RESULT_KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def _limits(root, cell, **limits):
    (root / 'benchmark' / 'limits' / f'{cell}.json').write_text(json.dumps(limits))


@pytest.mark.parametrize('trace', [False, True])
def test_result_line_has_its_keys(small_root, trace):
    r = harness.run_cell(small_root, 'unet3v.ref', 11, 2.5, trace, 'cpu', log=lambda *a: None)
    keys = list(r)
    assert keys[:5] == RESULT_KEYS
    assert keys[-1] == 'check'
    assert set(keys) == set(RESULT_KEYS) | {'check'} | ({'breakdown'} if trace else set())
    assert set(r['device']) >= {'platform', 'kind', 'count', 'memory_peak_bytes'}
    assert all(set(row) == {'value', 'limit'} for row in r['check'].values())
    json.dumps(r)
    if trace:
        assert set(r['device']) >= {'busy_s', 'window_s'}
        assert set(r['breakdown']) == {'device_ops', 'idle_gaps'}
        assert 'step_mfu_pct' in r['metrics']
    else:
        assert set(r['metrics']) == {'samples_per_s', 'step_p90_s', 'peak_mem_GiB', 'setup_s'}
        assert all(set(m) == {'value', 'unit'} for m in r['metrics'].values())


def test_cell_config_traffic_and_metric_are_added_as_files(small_root):
    """A later change adds a cell with its own configuration, traffic mix and
    per-layer metric: new files and new entries in BENCHMARK.json, no edit of a
    file of the harness."""
    b = small_root / 'benchmark'
    cfg = json.loads((b / 'configs' / 'hybrid_unet_mmwhs.json').read_text())
    cfg['config']['base_views'] = ['p2CH', 'p4CH']
    (b / 'configs' / 'unet2v_small.json').write_text(json.dumps(cfg))
    traffic = json.loads((b / 'traffic' / 'sweep_ref.json').read_text())
    traffic.update(stage='opt_view1', pool_cases=8)
    (b / 'traffic' / 'sweep_opt_view1.json').write_text(json.dumps(traffic))
    (b / 'metrics' / 'steps_in_window.py').write_text(
        "def read(run):\n    return float(len(run.window['step_s']))\n")
    bench = json.loads((small_root / 'BENCHMARK.json').read_text())
    bench['configs'].append(dict(bench['configs'][0], name='unet2v_small',
                                 file='benchmark/configs/unet2v_small.json'))
    bench['workloads'].append(dict(bench['workloads'][0], name='unet2v.opt_view1',
                                   config='unet2v_small', traffic='sweep_opt_view1'))
    bench['per_layer'].append({'name': 'steps_in_window', 'unit': 'steps', 'better': 'higher',
                               'source': 'host_clock', 'layer': 'training step',
                               'moves': 'samples_per_s', 'workloads': ['unet2v.opt_view1']})
    (small_root / 'BENCHMARK.json').write_text(json.dumps(bench))
    _limits(small_root, 'unet2v.opt_view1', loss1_gap=1e-4, grad_norm_shift=1e-3)
    r = harness.run_cell(small_root, 'unet2v.opt_view1', 5, 0.5, True, 'cpu',
                         log=lambda *a: None)
    assert r['metrics']['steps_in_window']['value'] == r['attempted'] >= 1
    assert r['correct'], r['check']


def _plant(monkeypatch, kind):
    """A fault underneath the program's train_step: an optimizer that never moves
    its parameters, or a loss over the first half of each microbatch's rows (the
    forward, and the Dice read back, over all of them)."""
    from acquisition_focus_tpu_torch.engine import train
    if kind == 'half_batch':
        real_loss = train.dice_ce_loss

        def half_loss(logits, target, *args, **kwargs):
            half = logits.shape[0] // 2
            return real_loss(logits[:half], target[:half], *args, **kwargs)
        monkeypatch.setattr(train, 'dice_ce_loss', half_loss)
        return
    real = train.train_step

    class _Still:
        """An optimizer that never moves its parameters."""

        def __init__(self, opt):
            self.opt = opt

        def zero_grad(self, set_to_none=True):
            self.opt.zero_grad(set_to_none=set_to_none)

        def step(self):
            pass

    def step(spec, unet, atms, recon_opt, trans_opt, batch, gen=None, mesh=None):
        return real(spec, unet, atms, (_Still(recon_opt[0]), recon_opt[1]),
                    (_Still(trans_opt[0]), trans_opt[1]), batch, gen, mesh)
    monkeypatch.setattr(train, 'train_step', step)


@pytest.mark.parametrize('cell', ['unet3v.opt_view2', 'unet3v.ref'])
@pytest.mark.parametrize('fault', [None, 'unchanged', 'half_batch'])
def test_a_broken_step_is_not_correct(small_root, monkeypatch, cell, fault):
    """The cell's own limits, on the small float32 shapes: a sound step passes
    them; a step that leaves the state unchanged, or that leaves half of the
    batch out, fails them."""
    shutil.copy(harness.Path(harness.__file__).parent / 'limits' / f'{cell}.json',
                small_root / 'benchmark' / 'limits' / f'{cell}.json')
    if fault:
        _plant(monkeypatch, fault)
    r = harness.run_cell(small_root, cell, 77, 0.2, False, 'cpu', log=lambda *a: None)
    assert r['correct'] is (fault is None), r['check']


@pytest.mark.parametrize('cell', ['unet3v.opt_view2', 'unet3v.ref'])
def test_the_control_is_not_correct(small_root, cell):
    """The reference in the precision below the configuration's (fp8 for the bf16
    U-Net), put in the program's place, fails the cell's limits; the small shapes
    run the program in float32, which passes them (test above)."""
    from benchmark import check, control
    shutil.copy(harness.Path(harness.__file__).parent / 'limits' / f'{cell}.json',
                small_root / 'benchmark' / 'limits' / f'{cell}.json')
    limits = harness.load_cell(small_root, cell).limits
    rows = control.seed_readings(small_root, cell, 5, ['control'], 'cpu', log=lambda *a: None)
    numbers = {r['side']: r['numbers'] for r in rows}
    assert check.judge(numbers['program'], limits)[0]
    assert not check.judge(numbers['control'], limits)[0]
    assert not check.judge(numbers['unchanged'], limits)[0]
