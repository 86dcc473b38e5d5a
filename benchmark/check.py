"""The comparison that decides `correct` for a training cell.

The program's first steps (driven in set-up through the window's own call and
feed) against the reference's same steps, from the same weights, cases and
augmentation draws. ``NUMBERS`` holds every number that a cell's limits file may
name; a run computes those its cell names:

* ``loss1_gap``: the absolute difference of the first step's loss;
* ``theta1_gap_median``: the median absolute difference of an entry of the
  learned view affines (each active view's transform module's output) in the
  first step; infinite where the two sides ran different modules or samples; 0
  where none runs. At initialization the rotation comes from Gram-Schmidt of six
  outputs near 0.01, which magnifies any rounding in its largest entry; the
  median entry is steady from seed to seed;
* ``grad_gap_median``: by the median updated leaf, the gap between the norms of
  the first step's gradient (the program's worked out from its optimizer's first
  moment: exp_avg / (1 - beta1)), over the larger of the reference's norm of that
  leaf and of the median updated leaf;
* ``grad_norm_shift``: the median, over the reconstruction model's leaves, of
  the relative shift of a leaf's first-gradient norm, (program - reference) /
  reference, in absolute value. The bf16 step's rounding moves a leaf's norm up
  or down by a fraction of a percent; a gradient over half of the rows (two
  samples of one kind average to a shorter vector than either) or one that
  rounds its small entries away moves most leaves' norms one way, so the
  median leaf reads it;
* ``grad_dir_gap_median``: by the median leaf, 1 - the cosine between the
  program's first gradient of a leaf and the reference's: a gradient with the
  right norms and the wrong rows, signs or mask reads it where norms cannot;
* ``change_gap``: by the worst leaf, the gap of the norms of each leaf's change
  over the checked steps, over the larger of the reference's and the median
  leaf's; leaves the reference does not update must not move at all;
  ``recon_change_gap`` over the reconstruction model's leaves alone;
  ``atm_change_gap_median`` by the median leaf of the transform modules that
  train (a module that does not move, or moves double, reads about 1);
* ``leaf_mismatch``: leaves that one side's optimizer updates and the other's
  does not.

Leaves whose reference gradient is under a thousandth of the median updated
leaf's (a bias under an instance norm, whose gradient is rounding) move under
Adam by round-off alone: they are left out of the change and direction gaps by
that rule. A number that is not finite fails its limit.
"""

import math
import statistics
from functools import cached_property


def _gap(p, r, floor):
    if not math.isfinite(p):
        return math.inf
    return abs(p - r) / max(r, floor) if max(r, floor) > 0 else abs(p - r)


def dice_gap(prog, ref):
    """The largest difference, over samples and classes, of two hard Dice
    tables; infinite where they hold different samples or empty classes."""
    if prog is None or len(prog) != len(ref) or any(len(a) != len(b) for a, b in zip(prog, ref)):
        return math.inf
    gap = 0.0
    for a, b in zip((x for row in prog for x in row), (x for row in ref for x in row)):
        if math.isnan(a) != math.isnan(b):
            return math.inf
        if not math.isnan(a):
            gap = max(gap, abs(a - b))
    return gap


def theta_gaps(prog, ref):
    """(largest, median) absolute difference of the entries of one step's thetas."""
    flat = [[x for t in side for row in t for col in row for x in col] for side in (prog, ref)]
    if prog is None or len(prog) != len(ref) or len(flat[0]) != len(flat[1]):
        return math.inf, math.inf
    diffs = [abs(x - y) if math.isfinite(x) else math.inf for x, y in zip(*flat)]
    return (max(diffs), statistics.median(diffs)) if diffs else (0.0, 0.0)


def _dir_gap(p, r):
    """1 - cos between two gradients of one leaf (float64); 1 without a gradient."""
    if p is None:
        return 1.0
    p, r = p.double().flatten(), r.double().flatten()
    if not bool(p.isfinite().all()):
        return math.inf
    den = float(p.norm() * r.norm())
    return 1.0 - float(p @ r) / den if den > 0 else 1.0


class Gaps:
    """The per-leaf and per-step gaps between the program's readings ``prog``
    ({'loss': [...], 'dice', 'thetas': [per step], 'grad': {leaf: norm} and
    'grad_vec': {leaf: tensor} for the leaves its optimizers hold state for,
    'change': {leaf: norm} for every leaf}) and the reference's ``train_steps``
    result, each worked out when a number first asks for it."""

    def __init__(self, prog, ref):
        self.prog, self.ref = prog, ref
        self.updated = set(ref['updated'])
        self.med_g = statistics.median(ref['grad'][n] for n in self.updated)
        self.quiet = {n for n in self.updated if ref['grad'][n] < 1e-3 * self.med_g}
        self.moved = self.updated - self.quiet

    @cached_property
    def losses(self):
        return [abs(p - r) if math.isfinite(p) else math.inf
                for p, r in zip(self.prog['loss'], self.ref['loss'])]

    @cached_property
    def grads(self):
        return {n: _gap(self.prog['grad'].get(n, 0.0), self.ref['grad'][n], self.med_g)
                for n in self.updated}

    @cached_property
    def directions(self):
        vec = self.prog.get('grad_vec', {})
        return {n: _dir_gap(vec.get(n), self.ref['grad_vec'][n]) for n in self.moved}

    @cached_property
    def changes(self):
        med_c = statistics.median(self.ref['change'][n] for n in self.moved)
        return {n: _gap(self.prog['change'][n], self.ref['change'][n], med_c)
                for n in self.ref['change'] if n not in self.quiet}

    def thetas(self, step, trained=False):
        """Gaps of one step's thetas: of every active view, or of the views whose
        modules train."""
        prog, ref = self.prog.get('thetas'), self.ref['thetas'][step]
        if prog is None or len(prog) <= step or len(prog[step]) != len(ref):
            return math.inf, math.inf
        prog = prog[step]
        if trained:
            keep = self.ref['theta_trains']
            prog, ref = ([t for t, k in zip(side, keep) if k] for side in (prog, ref))
        return theta_gaps(prog, ref)

    def worst(self):
        return {'grad_gap': max(self.grads, key=self.grads.get),
                'change_gap': max(self.changes, key=self.changes.get),
                'quiet_leaves': len(self.quiet)}


def _median_or_inf(values):
    return statistics.median(values) if values else math.inf


NUMBERS = {
    'loss1_gap': lambda g: g.losses[0],
    'theta1_gap_median': lambda g: g.thetas(0)[1],
    'grad_gap_median': lambda g: statistics.median(g.grads.values()),
    'grad_norm_shift': lambda g: abs(statistics.median(
        (g.prog['grad'].get(n, 0.0) - g.ref['grad'][n]) / g.ref['grad'][n]
        for n in g.moved if n.startswith('recon.'))),
    'grad_dir_gap_median': lambda g: statistics.median(g.directions.values()),
    'change_gap': lambda g: max(g.changes.values()),
    'recon_change_gap': lambda g: max(v for n, v in g.changes.items()
                                      if n.startswith('recon.')),
    'atm_change_gap_median': lambda g: _median_or_inf(
        [v for n, v in g.changes.items() if n.startswith('atms.') and n in g.moved]),
    'leaf_mismatch': lambda g: float(len(set(g.prog['grad']) ^ g.updated)),
}


def compare(prog, ref, names, extra=None):
    """-> ({name: value} for ``names``, {what: worst leaf}); ``extra`` adds
    numbers of the same form ({name: function of a ``Gaps``})."""
    table = dict(NUMBERS, **(extra or {}))
    g = Gaps(prog, ref)
    return {n: table[n](g) for n in names}, g.worst()


def judge(numbers, limits):
    """(correct, {name: {'value', 'limit'}}) over the numbers that ``limits``
    names: each at or under its limit. No limit at all is no check: not correct."""
    table = {n: {'value': numbers[n], 'limit': lim} for n, lim in limits.items()}
    ok = bool(table) and all(t['value'] <= t['limit'] for t in table.values())
    return ok, table
