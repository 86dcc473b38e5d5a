"""Dispatcher ops per step that the recompute regions' selective policy computes
again in backward: the program's counter ``recompute.ops``
(``models/recompute.py``), the mean over the traced steps, which are the last
steps the program closed into its ring of recent steps."""


def read(run):
    if run.trace is None:
        return None
    try:
        from acquisition_focus_tpu_torch.utils import spans
    except ImportError:         # a program without the counters
        return None
    steps = spans.recent_steps(run.trace.n_steps)
    if len(steps) < run.trace.n_steps:
        return None
    return sum(s.counts.get('recompute.ops', 0) for s in steps) / len(steps)
