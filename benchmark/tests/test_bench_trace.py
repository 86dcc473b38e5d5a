"""The traced span's arithmetic on a made-up trace: busy time, idle gaps, kernels
attributed to ranges by the CPU op that launched them, and the readers on it."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.trace import Activity, Call, Trace, breakdown, merged_length


def _trace():
    # two steps, 0-100 and 100-200 us; main thread 1, autograd thread 2
    device_ops = [('sm90_wgrad_kernel', 10, 30), ('elementwise_kernel', 25, 40),
                  ('plane_fwd_kernel', 50, 60), ('sm90_wgrad_kernel', 110, 130)]
    cpu_ops = [('aten::conv', 1, 5, 9, 20.0), ('aten::add', 1, 20, 24, 15.0),
               ('afocus::skip_concat_fwd', 1, 45, 48, 10.0), ('aten::conv_bwd', 2, 105, 109, 20.0),
               ('aten::copy_', 1, 70, 95, 0.0)]
    ranges = {'bench.step': [(1, 0, 100), (1, 100, 200)], 'skip_fwd': [(1, 44, 49)]}
    calls = [Call('skip_fwd', True, [((2, 48, 128, 128), 'float32', 6291456)],
                  [((2, 96, 128, 128, 128), 'bfloat16', 805306368)])]
    return Trace(2, device_ops, cpu_ops, ranges, calls, (0, 200))


def test_busy_idle_and_attribution():
    t = _trace()
    assert t.busy_intervals() == [[10, 40], [50, 60], [110, 130]]
    assert t.busy_us() == 60
    assert t.device_us_in('skip_fwd') == 10.0
    assert t.device_us_in('atm_fwd') is None
    b = breakdown(t)
    assert b['device_ops'][0] == ['sm90_wgrad_kernel', pytest.approx(40e-6)]
    gaps = dict(b['idle_gaps'])
    assert gaps['aten::copy_'] == pytest.approx(50e-6)        # 60-110, host in copy_
    assert sum(gaps.values()) == pytest.approx(140e-6)


def test_merged_length_counts_overlaps_once():
    assert merged_length([(50, 60), (10, 30), (25, 40), (12, 20)]) == 40


@pytest.mark.parametrize('metric, expected', [
    ('device_idle_pct', 70.0), ('cudnn_wgrad_ms', 0.02), ('eager_other_ms', 0.0075)])
def test_readers_on_the_made_up_trace(metric, expected):
    # the device's activity alone over two steps, 60 us busy in a span of 240 us;
    # the untraced steps take 100 us
    run = SimpleNamespace(trace=_trace(), activity=Activity(2, 60.0, 240.0),
                          window={'step_s': [90e-6, 100e-6, 130e-6]})
    assert harness.reader(harness.Path(__file__).resolve().parents[2], metric).read(run) \
        == pytest.approx(expected)


def test_skip_roofline_reads_bytes_over_time():
    run = SimpleNamespace(trace=_trace())
    r = harness.reader(harness.Path(__file__).resolve().parents[2], 'skip_fwd_roofline')
    nbytes = 6291456 + 805306368
    assert r.read(run) == pytest.approx(100.0 * nbytes / 3.35e12 / 10e-6)
