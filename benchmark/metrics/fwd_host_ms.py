"""Host ms per step in the program's ``af.forward`` spans: each microbatch's
``forward`` of ``engine/train.py::train_step`` (prescan, ATMs, slicing, the
reconstruction model, the loss)."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run.trace, 'af.forward')
