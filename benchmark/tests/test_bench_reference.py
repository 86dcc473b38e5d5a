"""The reference against the program on the CPU at small sizes, both in float32:
the same losses, gradients and updates to rounding."""

import json

import pytest
import torch

from benchmark import check, control, harness, weights as bench_weights
from benchmark.reference import step as ref_step
from benchmark.reference.precision import Precision


@pytest.mark.parametrize('cell', ['unet3v.opt_view2', 'unet3v.ref'])
def test_reference_follows_the_programs_steps(small_root, cell):
    c = harness.load_cell(small_root, cell)
    run = harness.Run(c, 20241018, 'cpu', 0.0)
    prog = run.checked_steps()
    run.free()
    numbers, _ = check.compare(prog, run.reference(),
                               ['loss1_gap', 'grad_gap', 'grad_gap_median', 'grad_dir_gap',
                                'theta2_gap_median', 'theta3_gap_median',
                                'leaf_mismatch'], control.DIAGNOSTICS)
    assert numbers['loss1_gap'] < 1e-5
    assert numbers['grad_gap'] < 1e-3
    assert numbers['grad_gap_median'] < 1e-5
    assert numbers['grad_dir_gap'] < 1e-6
    assert numbers['theta2_gap_median'] < 1e-4
    assert numbers['theta3_gap_median'] < 1e-2
    assert numbers['leaf_mismatch'] == 0
    assert run.departures == []


def test_epix2vox_reference_forward_is_the_programs():
    """(E)Pix2Vox's widths are fixed: one sample of two views through both models'
    interface and forward, same weights, float32."""
    from acquisition_focus_tpu_torch.models.epix2vox import (
        EPix2VoxModel128, epix2vox_interface_input, epix2vox_interface_output)
    cfg = json.loads((harness.Path(__file__).resolve().parents[1] / 'configs' /
                      'epix2vox_mmwhs_id21.json').read_text())
    spec = ref_step.stage_spec(cfg['config'], cfg['num_classes'], 'ref')
    recon, atms = ref_step.build(spec, 'epix2vox', 'cpu')
    kinds = ref_step.init_kinds(spec, 'epix2vox', recon, atms)
    shapes = {f'{p}.{n}': tuple(t.shape) for p, m in (('recon', recon), ('atms', atms))
              for n, t in m.named_parameters()}
    w = bench_weights.make_weights(kinds, shapes, 3, 'cpu')
    prog = EPix2VoxModel128(2)
    recon_w = {k: v for k, v in w.items() if k.startswith('recon.')}
    bench_weights.load_into(recon_w, {'recon': prog})
    bench_weights.load_into(recon_w, {'recon': recon})
    b_input = torch.rand(1, 12, 128, 128, generator=torch.Generator().manual_seed(0))
    grid = torch.eye(4).expand(2, 1, 4, 4)
    with torch.no_grad():
        mine = epix2vox_interface_output(prog(epix2vox_interface_input(b_input, 2)))
        ref = ref_step.model_module('epix2vox').logits(recon, b_input, grid, spec, Precision())
    assert mine.shape == ref.shape == (1, 2, 128, 128, 128)
    assert (mine - ref).abs().max() < 1e-4
