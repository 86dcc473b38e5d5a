"""Device ms per step of the kernels that fall in no named group: eager
elementwise work of the resampling, the loss, the norms and the recompute."""

from benchmark.metrics._groups import OTHER, group_of


def read(run):
    t = run.trace
    if t is None:
        return None
    us = sum(e - s for name, s, e in t.ops_in_window() if group_of(name) == OTHER)
    return us / 1e3 / t.n_steps if us > 0 else None
