"""Device ms per step of cuDNN's weight-gradient kernels (group 'cuDNN wgrad' of
the frozen kernel groups: K4's own kernel is matched before it)."""

from benchmark.metrics._groups import group_of


def read(run):
    t = run.trace
    if t is None:
        return None
    us = sum(e - s for name, s, e in t.ops_in_window() if group_of(name) == 'cuDNN wgrad')
    return us / 1e3 / t.n_steps if us > 0 else None
