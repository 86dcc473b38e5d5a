"""Readings that set a cell's limits: the program against the reference, and the
control and the faults that `correct` must reject, over many seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--sides program control half_batch]

For each seed, set-up as in a run (weights, cases, the checked first steps
through the program), then the float32 reference of the same steps, then each
asked-for stand-in compared with that reference exactly as `correct` compares
the program: 'control' is the reference in the precision below the
configuration's (the configuration file's ``control``), 'half_batch' the
reference whose loss takes each microbatch's first half of rows only (the
forward and the Dice all of them),
'precision:<name>' the reference in that precision. A state left unchanged is
read without a run: every leaf's change 0. ``--program-float32``: a witness, the
program itself computing in float32 with TF32 off. One JSON line per seed
and side on standard output, and in ``--out`` if given. The benchmark's own runs
never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import check  # noqa: E402


def _quantile(values, q):
    values = sorted(values)
    return values[int(q * (len(values) - 1))]


def _of(values, fold):
    values = list(values)
    return fold(values) if values else None


# numbers read beside the yardstick's, to find which of them separate the sound
# program from the control and the faults; no limit names them
DIAGNOSTICS = {
    'loss_gap': lambda g: max(g.losses),
    'dice1_gap': lambda g: check.dice_gap(g.prog.get('dice'), g.ref['dice']),
    'theta2_gap_median': lambda g: g.thetas(1, trained=True)[1],
    'theta1_gap': lambda g: g.thetas(0)[0],
    'theta3_gap_median': lambda g: g.thetas(2, trained=True)[1],
    'grad_gap': lambda g: max(g.grads.values()),
    'recon_grad_gap': lambda g: max(v for n, v in g.grads.items() if n.startswith('recon.')),
    'atm_grad_gap': lambda g: _of((v for n, v in g.grads.items() if n.startswith('atms.')), max),
    'atm_grad_gap_median': lambda g: _of(
        (v for n, v in g.grads.items() if n.startswith('atms.') and n in g.moved),
        statistics.median),
    'atm_grad_dir_gap_median': lambda g: _of(
        (v for n, v in g.directions.items() if n.startswith('atms.')), statistics.median),
    'recon_grad_dir_gap_median': lambda g: _of(
        (v for n, v in g.directions.items() if n.startswith('recon.')), statistics.median),
    'grad_dir_gap': lambda g: max(g.directions.values()),
    'grad_dir_gap_q10': lambda g: _quantile(g.directions.values(), 0.10),
    'grad_dir_gap_q25': lambda g: _quantile(g.directions.values(), 0.25),
    'change_gap_median': lambda g: statistics.median(g.changes[n] for n in g.moved),
    'atm_change_gap': lambda g: _of(
        (v for n, v in g.changes.items() if n.startswith('atms.') and n in g.moved), max),
}


def readings_of(result):
    """A stand-in's ``train_steps`` result in the program's readings' form."""
    return {'loss': result['loss'], 'dice': result['dice'], 'thetas': result['thetas'],
            'grad': {n: result['grad'][n] for n in result['updated']},
            'grad_vec': result['grad_vec'], 'change': result['change']}


def _plain(readings):
    """The readings without the gradients' tensors, for a JSON line."""
    return {k: v for k, v in readings.items() if k != 'grad_vec'}


@contextlib.contextmanager
def tf32_off(on=True):
    """TF32 off for float32 convolutions and matmuls inside, as it was after."""
    import torch
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if on:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def seed_readings(root, workload, seed, sides, device='cuda', log=print,
                  program_float32=False):
    """The rows of one seed. The program runs as the configuration states (TF32
    as the process has it), the reference and its stand-ins with TF32 off."""
    from benchmark import harness
    cell = harness.load_cell(root, workload)
    if program_float32:
        cell.config['config']['compute_dtype'] = 'float32'
    with tf32_off(program_float32):
        run = harness.Run(cell, seed, device, T0)
        prog = run.checked_steps()
    run.free()
    with tf32_off():
        return _sides(run, cell, workload, seed, sides, prog, program_float32, log)


def _sides(run, cell, workload, seed, sides, prog, program_float32, log):
    t = time.perf_counter()
    ref = run.reference()
    ref_s = time.perf_counter() - t
    rows = []

    names = list(check.NUMBERS) + list(DIAGNOSTICS)

    def row(side, readings, seconds=None):
        numbers, worst = check.compare(readings, ref, names, DIAGNOSTICS)
        rows.append({'workload': workload, 'seed': seed, 'side': side, 'numbers': numbers,
                     'worst': worst, 'seconds': seconds, 'loss': readings['loss'],
                     'readings': _plain(readings), 'reference': _plain(ref)})
        log(json.dumps({k: v for k, v in rows[-1].items()
                        if k not in ('readings', 'reference')}))

    row('program_float32' if program_float32 else 'program', prog, ref_s)
    row('unchanged', dict(readings_of(ref), change={n: 0.0 for n in ref['change']}))
    for side in sides:
        t = time.perf_counter()
        if side == 'control':
            other = run.reference(precision=cell.config['control'])
        elif side.startswith('precision:'):
            other = run.reference(precision=side.split(':', 1)[1])
        else:
            other = run.reference(fault=side)
        row(side, readings_of(other), time.perf_counter() - t)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--sides', nargs='*', default=['control', 'half_batch'])
    ap.add_argument('--out')
    ap.add_argument('--program-float32', action='store_true')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, 'a') if args.out else None
    try:
        for seed in args.seeds:
            for r in seed_readings(ROOT, args.workload, seed, args.sides,
                                   program_float32=args.program_float32):
                if out:
                    out.write(json.dumps(r) + '\n')
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
