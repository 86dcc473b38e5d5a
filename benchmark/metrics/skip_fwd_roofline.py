"""The skip connectors' forwards against their bytes bound: every SkipConnector
forward call's tensor inputs read once and its output written once, at 3.35 TB/s,
over the device time of every kernel those forwards launched."""

from benchmark.metrics._roofline import HBM_BYTES_PER_S

RANGE = 'skip_fwd'


def ranges(models):
    return [(RANGE, m) for m in models['recon'].modules()
            if type(m).__name__ == 'SkipConnector']


def read(run):
    t = run.trace
    if t is None:
        return None
    nbytes = sum(sum(b for _, _, b in c.inputs) + sum(b for _, _, b in c.output)
                 for c in t.calls if c.range == RANGE and c.main_thread)
    us = t.device_us_in(RANGE)
    if not nbytes or not us:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / (us * 1e-6)
