"""1 - (device busy time per step) / (the untraced window's median step): the
busy time is the union of the device operations' intervals over the traced span
that records the device's activity alone. The span's own wall time is longer
than an untraced step by the profiler's record of each launch, so it is not the
denominator."""

import statistics


def read(run):
    a = getattr(run, 'activity', None)
    steps = run.window['step_s']
    if a is None or not steps:
        return None
    return 100.0 * (1.0 - a.busy_us * 1e-6 / a.n_steps / statistics.median(steps))
