"""Device idle ms per step inside the program's ``af.backward`` spans: the time
in backward during which no device operation ran (the complement of the traced
span's busy intervals), where the host's backward work holds the device back."""

from benchmark.metrics._spans import idle_ms


def read(run):
    return idle_ms(run.trace, 'af.backward')
