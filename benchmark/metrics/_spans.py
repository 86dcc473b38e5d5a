"""The program's spans (``acquisition_focus_tpu_torch/utils/spans.py``) in a
traced run: a span enters ``record_function`` while the profiler records CPU
activity, so it lies among the trace's CPU ops by name, on the clock of the
device operations. A program without a span of that name (one from before the
spans) reads nothing."""

import bisect

from benchmark.trace import STEP_RANGE, merged_length


def spans_of(trace, name, main_thread=False):
    """``(thread, start, end)`` of the spans ``name`` inside the traced window,
    cut to it; ``main_thread``: only those on the thread of the steps."""
    main = {th for th, _, _ in trace.ranges.get(STEP_RANGE, [])}
    w0, w1 = trace.window
    return [(th, max(s, w0), min(e, w1)) for n, th, s, e, _ in trace.cpu_ops
            if n == name and e > w0 and s < w1 and (not main_thread or th in main)]


def host_ms(trace, name, main_thread=False):
    """Host ms per traced step inside the spans ``name``: per thread the length of
    their union, summed over the threads; None without such a span."""
    if trace is None:
        return None
    spans = spans_of(trace, name, main_thread)
    if not spans:
        return None
    by_thread = {}
    for th, s, e in spans:
        by_thread.setdefault(th, []).append((s, e))
    return sum(merged_length(v) for v in by_thread.values()) / 1e3 / trace.n_steps


def idle_ms(trace, name, main_thread=True):
    """Device idle ms per traced step inside the spans ``name`` (the union of the
    spans less the device's busy intervals); None without such a span."""
    if trace is None:
        return None
    spans = spans_of(trace, name, main_thread)
    if not spans:
        return None
    busy = trace.busy_intervals()
    starts = [s for s, _ in busy]
    idle, end = 0.0, -float('inf')
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        s = max(s, end)            # the union: overlaps counted once
        if e <= s:
            continue
        end = e
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(busy) and busy[i][0] < e:
            covered += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
        idle += (e - s) - covered
    return idle / 1e3 / trace.n_steps
