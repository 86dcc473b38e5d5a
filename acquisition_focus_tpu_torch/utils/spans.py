"""Spans and counters of the port's training step: the program's one store of
both.

**Spans.** ``with span(name):`` marks a phase of the program. It records when
the operator turns spans on (:func:`enable`; ``run_dl`` does so for the config
key ``trace_spans``) or while a ``torch.profiler`` is recording:

* under a profiler the span enters ``torch.profiler.record_function(name)``, so
  it lies in the Kineto trace on the clock of the device operations, where a
  reader can lay each device idle gap against the program's phase;
* with spans on it keeps a :class:`Record` in memory: name, parent span, step
  id, thread, and start and end from ``time.perf_counter_ns()``, and adds its
  duration to a per-name total (:func:`span_ns`).

The parent is the innermost span open on the same thread. A span opened on a
thread with none open, as autograd's thread running a recompute region in
backward, takes the innermost span open on the thread of the open step (there
``af.backward``). Off and with no profiler recording, :func:`span` returns a
shared no-op context: one branch, no allocation.

The program's spans:

=================  ==============================================  ============
span               where                                           parent
=================  ==============================================  ============
``af.step``        ``engine/train.py::train_step``, whole          -
``af.stage``       ``engine/runner.py::_to_device``                -
``af.forward``     each microbatch's ``forward``                   ``af.step``
``af.backward``    each microbatch's ``backward``                  ``af.step``
``af.recompute``   each replay of a ``models/recompute.py`` region ``af.backward``
                   in backward (autograd's thread on the card)
``af.grad_sync``   ``sync_gradients`` under a mesh                 ``af.step``
``af.optimizer``   the gradient mask, both optimizer and schedule  ``af.step``
                   steps
=================  ==============================================  ============

**Counters.** :func:`count` adds to a named counter; counters are always on,
plain integer adds with no lock: the threads that count do not run at once
(during backward the calling thread waits in the engine while autograd's thread
runs). Each keeps a running total (:func:`totals`, cleared per name prefix by
:func:`reset`), and :func:`step` (``af.step``) closes the counts made inside
each training step into a short ring of recent steps (:func:`recent_steps`). The program's counters: ``launch.<kernel>``, one per
hand-written kernel launch (``ops/kernels/_lib.py``, whose ``LAUNCHES`` is a view
of them); ``recompute.replays``, ``recompute.ops`` and ``recompute.served``
(``models/recompute.py``); ``collective.calls`` and ``collective.bytes``
(``parallel/collectives.py``).
"""

import collections
import collections.abc
import threading
import time
from dataclasses import dataclass

import torch.autograd.profiler as _profiler

RING_STEPS = 16          # steps whose counts recent_steps() keeps
MAX_RECORDS = 1 << 18    # span records kept in memory, the newest


@dataclass(frozen=True)
class Record:
    """One closed span: ``parent`` is the name of the span it opened in (or
    None), ``step`` the id of the step open when it opened (or None), times in
    ``time.perf_counter_ns()``."""
    name: str
    parent: object
    step: object
    thread: int
    start_ns: int
    end_ns: int

    @property
    def ms(self):
        return (self.end_ns - self.start_ns) * 1e-6


@dataclass(frozen=True)
class StepCounts:
    """The counts made inside one training step (``af.step``)."""
    step: int
    counts: dict


class _Tracer:
    """The process's spans and counters (one instance, :data:`_TRACER`)."""

    def __init__(self):
        self.on = False
        self.records = collections.deque(maxlen=MAX_RECORDS)
        self.span_ns = collections.Counter()
        self.open = {}                  # thread ident -> names of its open spans
        self.step = None                # (id, thread ident) of the open step
        self.next_step = 0
        self.totals = collections.Counter()
        self.current = collections.Counter()
        self.ring = collections.deque(maxlen=RING_STEPS)

    def parent(self, tid):
        stack = self.open.get(tid)
        if stack:
            return stack[-1]
        if self.step is not None and self.step[1] != tid:
            stack = self.open.get(self.step[1])
            if stack:
                return stack[-1]
        return None


_TRACER = _Tracer()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ('name', '_rf', '_stack', '_parent', '_step', '_t0')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        t = _TRACER
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        self._stack = None
        if t.on:
            tid = threading.get_ident()
            self._parent = t.parent(tid)
            self._step = t.step[0] if t.step is not None else None
            self._stack = t.open.setdefault(tid, [])
            self._stack.append(self.name)
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._stack is not None:
            t1 = time.perf_counter_ns()
            self._stack.pop()
            _TRACER.records.append(Record(self.name, self._parent, self._step,
                                          threading.get_ident(), self._t0, t1))
            _TRACER.span_ns[self.name] += t1 - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class _Step(_Span):
    """``af.step``: a span that also opens a step id and closes the step's counts
    into the ring, whether or not spans record."""
    __slots__ = ()

    def __init__(self):
        super().__init__('af.step')

    def __enter__(self):
        t = _TRACER
        t.current.clear()
        t.step = (t.next_step, threading.get_ident())
        t.next_step += 1
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        t = _TRACER
        t.ring.append(StepCounts(t.step[0], dict(t.current)))
        t.current.clear()
        t.step = None
        return False


def span(name):
    """A context manager that records the span ``name`` while spans are on or a
    profiler records (module docstring); a shared no-op otherwise."""
    if not (_TRACER.on or _profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name)


def step():
    """The ``af.step`` span of one training step (always a step boundary for the
    counters)."""
    return _Step()


def enable(on=True):
    """Turn the in-memory span records on or off (the operator's switch)."""
    _TRACER.on = bool(on)


def enabled():
    return _TRACER.on


def count(name, n=1):
    """Add ``n`` to the counter ``name``: its total and the open step's count."""
    _TRACER.totals[name] += n
    _TRACER.current[name] += n


def totals():
    """The counters' running totals (a copy)."""
    return dict(_TRACER.totals)


def reset(prefix=''):
    """Clear the running totals of the counters whose names start with ``prefix``."""
    for name in [k for k in _TRACER.totals if k.startswith(prefix)]:
        del _TRACER.totals[name]


def recent_steps(n=RING_STEPS):
    """The last ``n`` closed steps' counts (:class:`StepCounts`), oldest first."""
    ring = list(_TRACER.ring)
    return ring[max(0, len(ring) - n):]


def records():
    """The span records kept in memory, oldest first (a copy)."""
    return list(_TRACER.records)


def clear_records():
    _TRACER.records.clear()


def span_ns():
    """Total ns recorded per span name while spans were on (a copy)."""
    return dict(_TRACER.span_ns)


def per_step(span_before, totals_before, n_steps):
    """The operator's per-step export over ``n_steps`` training steps, from the
    :func:`span_ns` and :func:`totals` taken before them: ``perf/span/<name>_ms``,
    the mean host ms per step of each span, and ``perf/count/<name>``, the mean
    count per step of each counter."""
    if n_steps <= 0:
        return {}
    out = {}
    for name, ns in sorted(_TRACER.span_ns.items()):
        d = ns - span_before.get(name, 0)
        if d:
            out[f'perf/span/{name}_ms'] = d * 1e-6 / n_steps
    for name, total in sorted(_TRACER.totals.items()):
        d = total - totals_before.get(name, 0)
        if d:
            out[f'perf/count/{name}'] = d / n_steps
    return out


class CounterView(collections.abc.Mapping):
    """A read-only mapping of ``key -> total`` of the counters ``<prefix><key>``
    for fixed ``keys``."""

    def __init__(self, prefix, keys):
        self.prefix, self._names = prefix, tuple(keys)

    def __getitem__(self, key):
        if key not in self._names:
            raise KeyError(key)
        return _TRACER.totals[self.prefix + key]

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __repr__(self):
        return repr(dict(self))

    def reset(self):
        reset(self.prefix)
