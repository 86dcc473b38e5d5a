"""Host ms per step in the program's ``af.optimizer`` spans: the per-view
gradient mask, both optimizer steps and both schedule steps of
``engine/train.py::train_step``."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run.trace, 'af.optimizer')
