"""Host ms per step in the program's ``af.recompute`` spans, on any thread: the
replays of the recompute regions (``models/recompute.py``) in backward, which
run on autograd's thread."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run.trace, 'af.recompute')
