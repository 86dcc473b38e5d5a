"""Host ms per step in the program's ``af.backward`` spans on the thread of the
steps: each microbatch's ``backward`` call of ``engine/train.py::train_step``,
which waits there while autograd's thread runs the graph and its recompute."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run.trace, 'af.backward', main_thread=True)
