"""The traced spans of a ``--trace 1`` run.

The first span records the device's activity alone (no CPU ops, no ranges): the
device's busy time per step. Even so the profiler's record of each launch
stretches the host's share of a step, so the idle share divides that busy time
by the untraced window's median step, not by the span's own wall time. The
second span adds the CPU ops and ranges around module forwards, entered from the
benchmark's own hooks (nothing inside the program): the per-layer readers take
its parsed result. Its hooks and records stretch each step further.

A range is entered in a module's forward pre-hook and left in its forward hook,
so it covers the module's forward wherever it runs: in the step's forward on the
main thread, or again inside a recompute region during backward on autograd's
thread. Each call's tensor arguments and output are recorded (shape, dtype,
bytes) with the thread it ran on, so a reader can count the forward's own work.
A device kernel belongs to a range when the CPU op that launched it ran inside
the range, on the range's thread.
"""

import bisect
import threading
import time
from dataclasses import dataclass, field

import torch

STEP_RANGE = 'bench.step'


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _info(t):
    return (tuple(t.shape), str(t.dtype).replace('torch.', ''), t.numel() * t.element_size())


@dataclass
class Call:
    range: str
    main_thread: bool
    inputs: list
    output: list


class RangeHooks:
    """Ranges named ``name`` around the forwards of the given modules, while
    installed (``with``)."""

    def __init__(self, targets):
        self.targets = targets                  # [(range name, module)]
        self.calls = []
        self._handles = []
        self._open = {}
        self._main = threading.get_ident()

    def __enter__(self):
        for name, module in self.targets:
            self._handles.append(module.register_forward_pre_hook(self._pre(name)))
            self._handles.append(module.register_forward_hook(self._post(name)))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []

    def _pre(self, name):
        def hook(module, args):
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self._open.setdefault((id(module), threading.get_ident()), []).append(
                (rf, [_info(t) for t in _tensors(args)]))
        return hook

    def _post(self, name):
        def hook(module, args, output):
            rf, inputs = self._open[(id(module), threading.get_ident())].pop()
            rf.__exit__(None, None, None)
            self.calls.append(Call(name, threading.get_ident() == self._main, inputs,
                                   [_info(t) for t in _tensors(output)]))
        return hook


@dataclass
class Trace:
    """The parsed span: device operations (name, start, end), CPU ops (name,
    thread, start, end, device time of the kernels they launched), the ranges
    (name -> [(thread, start, end)]), module calls, in microseconds of the
    profiler's clock; ``window`` the span of the traced steps."""
    n_steps: int
    device_ops: list
    cpu_ops: list
    ranges: dict
    calls: list
    window: tuple
    _busy: list = field(default=None, repr=False)

    @property
    def window_us(self):
        return self.window[1] - self.window[0]

    def busy_intervals(self):
        """Merged intervals in which some device operation ran, inside the window."""
        if self._busy is None:
            spans = sorted((max(s, self.window[0]), min(e, self.window[1]))
                           for _, s, e in self.device_ops
                           if e > self.window[0] and s < self.window[1])
            merged = []
            for s, e in spans:
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._busy = merged
        return self._busy

    def busy_us(self):
        return sum(e - s for s, e in self.busy_intervals())

    def ops_in_window(self):
        return [op for op in self.device_ops if self.window[0] <= op[1] < self.window[1]]

    def device_us_in(self, range_name):
        """Device time of the kernels launched by CPU ops inside the ranges of that
        name (on the range's thread), or None without such a range."""
        ranges = self.ranges.get(range_name, [])
        if not ranges:
            return None
        by_thread = {}
        for thread, s, e in ranges:
            by_thread.setdefault(thread, []).append((s, e))
        for v in by_thread.values():
            v.sort()
        total = 0.0
        for _, thread, s, e, kernel_us in self.cpu_ops:
            spans = by_thread.get(thread)
            if not kernel_us or not spans or not self.window[0] <= s < self.window[1]:
                continue
            # ranges of one name follow each other on a thread, never nest
            i = bisect.bisect_right(spans, (s, float('inf'))) - 1
            if i >= 0 and spans[i][0] <= s and e <= spans[i][1]:
                total += kernel_us
        return total

    def host_activity(self, t):
        """The innermost CPU op or range running on any thread at time ``t``."""
        best = None
        for name, thread, s, e in self._host_index(t):
            if best is None or s > best[2]:
                best = (name, thread, s, e)
        return best[0] if best else 'no host op'

    def _host_index(self, t):
        if not hasattr(self, '_host_sorted'):
            ev = [op[:4] for op in self.cpu_ops]
            ev += [(n, th, s, e) for n, rs in self.ranges.items() for th, s, e in rs]
            ev.sort(key=lambda x: x[2])
            self._host_sorted = ev
            self._host_starts = [x[2] for x in ev]
        i = bisect.bisect_right(self._host_starts, t)
        out = []
        for j in range(i - 1, max(-1, i - 20000), -1):
            ev = self._host_sorted[j]
            if ev[3] >= t:
                out.append(ev)
        return out


def merged_length(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float('inf')
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


@dataclass
class Activity:
    """The device's activity over ``n_steps`` steps: the union of its operations'
    intervals and the steps' wall time by the host's clock, in microseconds."""
    n_steps: int
    busy_us: float
    window_us: float


def device_activity(step, n_steps):
    """Run ``step()`` (which ends in a read-back to the host) ``n_steps`` times
    under a profiler that records device operations alone."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return Activity(n_steps, merged_length(spans), (t1 - t0) * 1e6)


def profile_steps(step, n_steps, range_names):
    """Run ``step()`` ``n_steps`` times under the profiler, each in a
    ``bench.step`` range, and parse the result."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            with torch.autograd.profiler.record_function(STEP_RANGE):
                step()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    names = set(range_names) | {STEP_RANGE}
    device_ops, cpu_ops, ranges = [], [], {}
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in names and not getattr(e, 'is_user_annotation', False):
                device_ops.append((e.name, s, t))
        elif e.name in names:
            ranges.setdefault(e.name, []).append((e.thread, s, t))
        elif not e.is_async:
            # the profiler links each device kernel to the frontend op that
            # launched it (``kernels``: name, device, duration in us)
            cpu_ops.append((e.name, e.thread, s, t,
                            sum(k.duration for k in getattr(e, 'kernels', []))))
    steps = sorted(ranges.get(STEP_RANGE, []), key=lambda r: r[1])
    if len(steps) != n_steps:
        raise RuntimeError(f"the trace holds {len(steps)} of {n_steps} step ranges")
    window = (steps[0][1], steps[-1][2])
    return Trace(n_steps, device_ops, cpu_ops, ranges, [], window)


def breakdown(trace, top=10):
    """The device operations that took the most time and the longest idle gaps
    by what the host was doing, in seconds over the traced span."""
    by_op = {}
    for name, s, e in trace.ops_in_window():
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    busy = trace.busy_intervals()
    gaps = {}
    edges = [trace.window[0]] + [x for s, e in busy for x in (s, e)] + [trace.window[1]]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            what = trace.host_activity((a + b) / 2.0)
            gaps[what] = gaps.get(what, 0.0) + (b - a) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[n[:160], v] for n, v in ops],
            'idle_gaps': [[n[:160], v] for n, v in idle]}
