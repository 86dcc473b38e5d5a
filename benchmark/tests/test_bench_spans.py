"""The readers of the program's spans and counters on a made-up trace: host ms
per step in each ``af.*`` span, device idle ms inside ``af.backward``, the
``recompute.ops`` counter from the program's ring of recent steps, nothing read
from a program without spans, and the existing readers unmoved by the spans."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.trace import Trace, breakdown

ROOT = harness.Path(__file__).resolve().parents[2]
HOST_READERS = ['stage_host_ms', 'fwd_host_ms', 'bwd_host_ms', 'opt_host_ms',
                'recompute_host_ms', 'bwd_idle_ms']


def _trace(with_spans=True):
    # two steps, 0-100 and 100-200 us; main thread 1, autograd's thread 2
    device_ops = [('sm90_wgrad_kernel', 10, 30), ('elementwise_kernel', 25, 40),
                  ('plane_fwd_kernel', 50, 60), ('sm90_wgrad_kernel', 110, 130)]
    cpu_ops = [('aten::conv', 1, 7, 9, 20.0), ('afocus::skip_concat_fwd', 1, 45, 48, 10.0),
               ('aten::copy_', 1, 60, 78, 0.0)]
    if with_spans:
        cpu_ops += [
            ('af.stage', 1, 0, 5, 0.0), ('af.step', 1, 5, 95, 0.0),
            ('af.forward', 1, 6, 40, 15.0),        # a ctypes launch linked to the span
            ('af.backward', 1, 41, 80, 0.0), ('af.recompute', 2, 45, 55, 0.0),
            ('af.optimizer', 1, 81, 90, 0.0),
            ('af.stage', 1, 100, 104, 0.0), ('af.step', 1, 104, 196, 0.0),
            ('af.forward', 1, 105, 120, 0.0), ('af.backward', 1, 121, 170, 0.0),
            ('af.recompute', 2, 125, 135, 0.0), ('af.recompute', 2, 130, 140, 0.0),
            ('af.backward', 2, 150, 160, 0.0),     # not the steps' thread
            ('af.optimizer', 1, 171, 180, 0.0)]
    ranges = {'bench.step': [(1, 0, 100), (1, 100, 200)], 'skip_fwd': [(1, 44, 49)]}
    return Trace(2, device_ops, cpu_ops, ranges, [], (0, 200))


def read(metric, run):
    return harness.reader(ROOT, metric).read(run)


@pytest.mark.parametrize('metric, expected_us', [
    ('stage_host_ms', (5 + 4) / 2),
    ('fwd_host_ms', (34 + 15) / 2),
    ('bwd_host_ms', (39 + 49) / 2),              # the steps' thread only
    ('opt_host_ms', (9 + 9) / 2),
    ('recompute_host_ms', (10 + 15) / 2),        # overlapping replays counted once
    ('bwd_idle_ms', ((39 - 10) + (49 - 9)) / 2),  # busy 50-60 and 121-130 inside
])
def test_span_readers_on_the_made_up_trace(metric, expected_us):
    got = read(metric, SimpleNamespace(trace=_trace()))
    assert got == pytest.approx(expected_us / 1e3)


def test_backward_idle_is_at_most_its_host_time():
    run = SimpleNamespace(trace=_trace())
    assert read('bwd_idle_ms', run) <= read('bwd_host_ms', run)


@pytest.mark.parametrize('metric', HOST_READERS + ['recompute_ops'])
def test_a_program_without_spans_reads_nothing(metric):
    assert read(metric, SimpleNamespace(trace=None)) is None
    if metric != 'recompute_ops':
        assert read(metric, SimpleNamespace(trace=_trace(with_spans=False))) is None


def test_recompute_ops_is_the_mean_over_the_traced_steps():
    from acquisition_focus_tpu_torch.utils import spans
    for n in (10, 20, 30):
        with spans.step():
            spans.count('recompute.ops', n)
    assert read('recompute_ops', SimpleNamespace(trace=_trace())) == 25.0
    spans.reset('recompute.')


def test_spans_leave_the_range_readers_and_name_the_gaps():
    with_spans, without = _trace(), _trace(with_spans=False)
    assert with_spans.device_us_in('skip_fwd') == without.device_us_in('skip_fwd') == 10.0
    run = SimpleNamespace(trace=with_spans)
    assert read('eager_other_ms', run) == read('eager_other_ms', SimpleNamespace(trace=without))
    gaps = dict(breakdown(with_spans)['idle_gaps'])
    assert 'af.backward' in gaps and 'af.optimizer' in gaps
