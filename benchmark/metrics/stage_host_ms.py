"""Host ms per step in the program's ``af.stage`` spans: the macrobatch staged
to the device by ``engine/runner.py::_to_device`` (the harness's own gather of
the host arrays, before it, lies outside)."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run.trace, 'af.stage')
