"""The reader of ``p2v_merge_fwd_roofline`` on a made-up trace: the ranges sit on
the merger's five convs, the bound comes from each main-thread forward call's
shapes, the time from the kernels launched inside the ranges, and a run without
a trace or without the ranges reads nothing."""

from types import SimpleNamespace

import pytest
import torch.nn as nn

from benchmark import harness
from benchmark.metrics._roofline import bound_s
from benchmark.trace import Call, Trace

ROOT = harness.Path(__file__).resolve().parents[2]
METRIC = 'p2v_merge_fwd_roofline'


def reader():
    return harness.reader(ROOT, METRIC)


def _info(shape):
    n = 1
    for s in shape:
        n *= s
    return (shape, 'float32', 4 * n)


def _trace(with_ranges=True):
    # one step 0-100 us; main thread 1, autograd's thread 2
    calls = [Call('p2v_merge_fwd', True, [_info((2, 9, 16, 16, 16))], [_info((2, 16, 16, 16, 16))]),
             Call('p2v_merge_fwd', True, [_info((2, 16, 16, 16, 16)), _info((2, 16))],
                  [_info((2, 8, 16, 16, 16)), _info((2, 8))]),
             Call('p2v_merge_fwd', False, [_info((2, 9, 16, 16, 16))],
                  [_info((2, 16, 16, 16, 16))])]
    cpu_ops = [('cudaLaunchKernel', 1, 11, 12, 30.0), ('cudaLaunchKernel', 1, 21, 22, 20.0),
               ('cudaLaunchKernel', 1, 50, 51, 99.0)]           # outside the ranges
    ranges = {'bench.step': [(1, 0, 100)]}
    if with_ranges:
        ranges['p2v_merge_fwd'] = [(1, 10, 15), (1, 20, 25)]
    return Trace(1, [('p2v_merge_fwd', 12, 42)], cpu_ops, ranges, calls, (0, 100))


def test_bound_from_the_main_thread_calls_over_the_ranges_device_time():
    vox = 16 ** 3
    bound = sum(bound_s(2.0 * 2 * co * ci * 27 * vox,
                        4 * (2 * ci * vox + co * ci * 27 + 2 * co * vox), 'tf32')
                for ci, co in ((9, 16), (16, 8)))
    got = reader().read(SimpleNamespace(trace=_trace()))
    assert got == pytest.approx(100.0 * bound / 50e-6)


def test_nothing_to_read_without_a_trace_or_its_ranges():
    assert reader().read(SimpleNamespace(trace=None)) is None
    assert reader().read(SimpleNamespace(trace=_trace(with_ranges=False))) is None


def test_ranges_sit_on_the_merger_convs_alone():
    from acquisition_focus_tpu_torch.models.epix2vox import Epix2VoxMerger
    recon = nn.Module()
    recon.merger = Epix2VoxMerger()
    recon.head = nn.Conv3d(9, 1, 3)
    targets = reader().ranges({'recon': recon})
    assert [m for _, m in targets] == [getattr(recon.merger, f'm{i}_conv') for i in range(5)]
    assert {r for r, _ in targets} == {'p2v_merge_fwd'}
