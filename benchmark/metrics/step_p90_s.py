"""The 90th percentile of the wall time of every step in the untraced window,
each step ending in its loss read (statistics.quantiles, inclusive; a window of
one step reads that step)."""

import statistics


def read(run):
    steps = run.window['step_s']
    if len(steps) < 2:
        return steps[0] if steps else None
    return statistics.quantiles(steps, n=10, method='inclusive')[-1]
