"""The whole step's share of the chip's peak: model FLOPs per step (counted from
the reference's shapes, ``benchmark/reference/flops.py``) times the steps of the
untraced window over its time, over the peak of the configuration's precision."""

from benchmark.metrics._roofline import PEAK_FLOPS


def read(run):
    rate = run.flops_per_step() * len(run.window['step_s']) / run.window['seconds']
    return 100.0 * rate / PEAK_FLOPS[run.precision]
