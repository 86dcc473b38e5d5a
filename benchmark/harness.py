"""One run of one cell: set-up, the measured window, the optional traced span,
and the check of the program's first steps against the reference.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``: the
cell's entry names its configuration (``benchmark/configs/<config>.json``, via
the configuration's ``file``) and its traffic (``benchmark/traffic/<traffic>.json``);
its metrics are the readers ``benchmark/metrics/<metric>.py`` of the end-to-end
metrics (``--trace 0``) or the per-layer metrics (``--trace 1``) that apply to it;
its limits are ``benchmark/limits/<cell>.json``.

The window drives the program's ``engine/train.py::train_step`` as its runner's
epoch loop does: a macrobatch of host arrays in a seeded order, staged to the
device by the runner's own ``_to_device``, a per-step seeded augmentation
generator, and the loss and dice read back to the host at the end of every step.
"""

import gc
import importlib.util
import json
import math
import statistics
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import check, trace as tracing, weights as bench_weights
from benchmark.reference import flops as ref_flops, step as ref_step
from benchmark.traffic import generator as traffic

CHECKED_STEPS = 3        # the first steps, in set-up, that the reference follows
TRACED_STEPS = 3         # the steps under the profiler in a --trace 1 run
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'acquisition_focus_tpu')


class CellError(Exception):
    pass


def load_cell(root, name):
    """The cell's entry, configuration file, traffic file, metrics and limits."""
    root = Path(root)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise CellError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c['name']: c for c in bench['configs']}[cell['config']]
    config = json.loads((root / entry['file']).read_text())
    flow = json.loads((root / 'benchmark' / 'traffic' / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench['end_to_end'] if name in m.get('workloads', [name])]
    per_layer = [m for m in bench['per_layer'] if name in m['workloads']]
    limits_file = root / 'benchmark' / 'limits' / f'{name}.json'
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return SimpleNamespace(name=name, entry=cell, config=config, traffic=flow, e2e=e2e,
                           per_layer=per_layer, limits=limits, root=root)


def reader(root, metric):
    path = Path(root) / 'benchmark' / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(f'benchmark_metric_{metric}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def program_spec(cell):
    """The program's StageSpec of the cell's stage, as its sweep builds it."""
    from acquisition_focus_tpu_torch.engine.config import load_config
    from acquisition_focus_tpu_torch.engine.runner import n_active_views_for, spec_from_config
    from acquisition_focus_tpu_torch.engine.stages import get_std_stages, merge_stage_config
    config = load_config(overrides=cell.config['config'])
    sweep = get_std_stages(dict(config, stage_override=cell.traffic['stage']))
    sweep.verbose = False
    stage_config = merge_stage_config(config, next(iter(sweep)))
    return stage_config, spec_from_config(stage_config, cell.config['num_classes'],
                                          n_active_views_for(stage_config), 'train')


def _spec_departures(spec, ref_spec):
    """Fields where the program's step departs from what the configuration states."""
    mine = dict(n_views=spec.n_views, num_classes=spec.num_classes,
                n_active_views=spec.n_active_views,
                view_optimization_mode=spec.view_optimization_mode,
                use_affine_theta=spec.use_affine_theta, model_type=spec.model_type,
                use_binarized_labels=spec.use_binarized_labels,
                num_grad_accum_steps=spec.num_grad_accum_steps,
                augment_input=spec.augment_input,
                train_mask=[bool(b) for b in spec.view_train_mask()])
    ref = dict(ref_spec, train_mask=ref_step.train_mask(ref_spec))
    return sorted(k for k, v in mine.items() if ref[k] != v)


class Run:
    """The program's side of one run: models, optimizers, cases and the step."""

    def __init__(self, cell, seed, device, t0):
        from acquisition_focus_tpu_torch.engine.optimizers import (
            make_epix2vox_optimizer, make_reconstruction_optimizer, make_transform_optimizer)
        from acquisition_focus_tpu_torch.engine.train import EPIX2VOX_TYPES, make_models
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        config, self.spec = program_spec(cell)
        self.ref_spec = ref_step.stage_spec(cell.config['config'], cell.config['num_classes'],
                                            cell.traffic['stage'])
        self.departures = _spec_departures(self.spec, self.ref_spec)
        self.B, self.accum = config['batch_size'], config['num_grad_accum_steps']
        self.phases = [('stage spec', time.perf_counter() - t0)]
        self.unet, self.atms = make_models(self.spec, self.device)
        self.phases.append(('make_models', time.perf_counter() - t0))
        self.kinds, self.shapes = self._init_table()
        bench_weights.load_into(self._weights(), {'recon': self.unet, 'atms': self.atms})
        self.phases.append(('weights', time.perf_counter() - t0))
        upe = max(1, int(cell.traffic['pool_cases']) // (self.B * self.accum))
        sched = config.get('use_scheduling', True)
        if self.spec.model_type in EPIX2VOX_TYPES:
            self.recon_opt = make_epix2vox_optimizer(self.unet, upe, sched)
        else:
            self.recon_opt = make_reconstruction_optimizer(self.unet.parameters(), config['lr'],
                                                           upe, sched)
        self.trans_opt = make_transform_optimizer(self.atms.parameters(), config['lr'],
                                                  config['epochs'], upe, sched)
        self.phases.append(('optimizers', time.perf_counter() - t0))
        self.pool = traffic.make_pool(cell.traffic, self.spec.n_views, self.spec.hires_fov_mm,
                                      self.spec.hires_fov_vox, self.seed, self.device)
        self.phases.append(('cases', time.perf_counter() - t0))
        self.order = traffic.macrobatches(len(self.pool), self.accum, self.B, self.seed)
        self.k = 0
        self.checked_ids = []

    def _init_table(self):
        recon, atms = ref_step.build(self.ref_spec, self.cell.config['reference'], 'meta')
        kinds = ref_step.init_kinds(self.ref_spec, self.cell.config['reference'], recon, atms)
        shapes = {f'{pre}.{n}': tuple(p.shape) for pre, m in (('recon', recon), ('atms', atms))
                  for n, p in m.named_parameters()}
        return kinds, shapes

    def _weights(self):
        return bench_weights.make_weights(self.kinds, self.shapes, self.seed, self.device)

    def named(self):
        return {f'{pre}.{n}': p for pre, m in (('recon', self.unet), ('atms', self.atms))
                for n, p in m.named_parameters()}

    def step(self):
        """One step as the runner takes it; returns (loss, dice (accum * B, C)),
        both read back to the host."""
        from acquisition_focus_tpu_torch.engine.runner import _to_device
        from acquisition_focus_tpu_torch.engine.train import train_step
        ids = next(self.order)
        batch = _to_device(traffic.stage(self.pool, ids, self.accum, self.B), self.device)
        out = train_step(self.spec, self.unet, self.atms, self.recon_opt, self.trans_opt, batch,
                         traffic.augment_generator(self.seed, self.k))
        loss = float(out['loss'])
        dice = out['dice'].cpu()
        self.k += 1
        return loss, dice, ids

    def checked_steps(self):
        """The first steps, through the window's own call and feed: each step's
        loss and learned thetas (the transform modules' forward outputs on the
        step's thread); the first step's dice; the first gradient, and its norms,
        from the optimizers' first moments; the norms of the leaves' change over
        the steps."""
        names = {id(p): n for n, p in self.named().items()}
        readings = {'loss': [], 'grad': {}, 'grad_vec': {}, 'change': {}, 'thetas': []}
        main = threading.get_ident()

        def keep_theta(module, args, out):
            # the forward's output on the step's own thread; a recompute in
            # backward runs on autograd's
            if threading.get_ident() == main:
                readings['thetas'][-1].append(out.detach().cpu().tolist())
        hooks = [m.register_forward_hook(keep_theta) for m in self.atms]
        for k in range(CHECKED_STEPS):
            readings['thetas'].append([])
            loss, dice, ids = self.step()
            readings['loss'].append(loss)
            self.checked_ids.append(ids)
            if k == 0:
                readings['dice'] = dice.tolist()
                with torch.no_grad():
                    for opt in (self.recon_opt[0], self.trans_opt[0]):
                        for group in opt.param_groups:
                            beta1 = group['betas'][0]
                            for p in group['params']:
                                if 'exp_avg' in opt.state.get(p, {}):
                                    g = opt.state[p]['exp_avg'] / (1.0 - beta1)
                                    readings['grad'][names[id(p)]] = float(g.norm())
                                    readings['grad_vec'][names[id(p)]] = g.float().to(
                                        'cpu', copy=True)
        for h in hooks:
            h.remove()
        start = self._weights()
        with torch.no_grad():
            for n, p in self.named().items():
                readings['change'][n] = float((p - start[n]).norm())
        del start
        return readings

    def free(self):
        for name in ('unet', 'atms', 'recon_opt', 'trans_opt'):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, precision='float32', fault=None):
        """The reference's readings of the checked steps, from the same weights,
        cases and augmentation draws."""
        from acquisition_focus_tpu_torch.engine.runner import _to_device
        batches = [_to_device(traffic.stage(self.pool, ids, self.accum, self.B), self.device)
                   for ids in self.checked_ids]
        gens = [traffic.augment_generator(self.seed, k) for k in range(len(batches))]
        return ref_step.train_steps(self.ref_spec, self.cell.config['reference'],
                                    self._weights(), batches, gens, precision, fault)


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)


def run_cell(root, name, seed, seconds, trace, device='cuda', t0=None, log=None):
    """-> the result dict of one run (the last line the benchmark prints)."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = load_cell(root, name)
    cuda = torch.device(device).type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize()

    log(f"set-up: imports {time.perf_counter() - t0:.3f} s")
    run = Run(cell, seed, device, t0)
    sync()
    log("set-up: " + ', '.join(f"{n} {t:.3f} s" for n, t in run.phases))
    readings = run.checked_steps()
    sync()
    setup_s = time.perf_counter() - t0
    log(f"set-up: {CHECKED_STEPS} checked steps {setup_s:.3f} s")

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step_s, failed = [], 0
    w0 = time.perf_counter()
    while True:
        s0 = time.perf_counter()
        loss, _, _ = run.step()
        s1 = time.perf_counter()
        step_s.append(s1 - s0)
        failed += not math.isfinite(loss)
        if s1 - w0 >= seconds:
            break
    log(f"window: {len(step_s)} steps, s/step {[round(x, 4) for x in step_s]}")
    window = {'seconds': s1 - w0, 'step_s': step_s, 'peak_bytes':
              torch.cuda.max_memory_allocated() if cuda else 0,
              'samples': len(step_s) * run.accum * run.B}

    metrics_meta = cell.per_layer if trace else cell.e2e
    readers = {m['name']: reader(root, m['name']) for m in metrics_meta}
    traced = activity = None
    if trace:
        targets, seen = [], {}
        models = {'recon': run.unet, 'atms': run.atms}
        for r in readers.values():
            for rng, module in getattr(r, 'ranges', lambda m: [])(models):
                if seen.setdefault(id(module), rng) != rng:
                    raise CellError(f"two ranges on one module: {seen[id(module)]}, {rng}")
                if (rng, module) not in targets:
                    targets.append((rng, module))
        activity = tracing.device_activity(run.step, TRACED_STEPS) if cuda else None
        with tracing.RangeHooks(targets) as hooks:
            traced = tracing.profile_steps(run.step, TRACED_STEPS, {r for r, _ in targets})
        traced.calls = hooks.calls
        median_step_us = statistics.median(step_s) * 1e6
        for what, span_us in (('device activity alone', activity and activity.window_us),
                              ('ranges and CPU ops', traced.window_us)):
            if span_us:
                log(f"trace: a step {what} {span_us / TRACED_STEPS / 1e3:.3f} ms, "
                    f"{span_us / TRACED_STEPS / median_step_us:.4f} of the untraced median")

    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules of JAX or of the JAX package were loaded: {bad[:10]}")

    flops_cache = []

    def flops_per_step():
        if not flops_cache:
            flops_cache.append(ref_flops.step_flops(run.ref_spec, cell.config['reference']))
        return flops_cache[0]

    ctx = SimpleNamespace(window=window, setup_s=setup_s, trace=traced, activity=activity,
                          precision=cell.config['precision'], flops_per_step=flops_per_step)
    metrics = {}
    for m in metrics_meta:
        value = readers[m['name']].read(ctx)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
                   'count': int(cell.entry['chips']),
                   'memory_peak_bytes': int(window['peak_bytes'])}
    result = {'correct': False, 'attempted': len(step_s), 'failed': failed,
              'metrics': metrics, 'device': device_info}
    if traced is not None:
        busy_us, window_us = ((activity.busy_us, activity.window_us) if activity else
                              (traced.busy_us(), traced.window_us))
        device_info['busy_s'] = busy_us * 1e-6
        device_info['window_s'] = window_us * 1e-6
        result['breakdown'] = tracing.breakdown(traced)

    run.free()
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = run.reference()
    # exact comparisons, whatever the cell's file sets: the leaves that the
    # optimizers update, and the step the configuration states
    limits = {'leaf_mismatch': 0.0, 'spec_departures': 0.0, **cell.limits}
    numbers, worst = check.compare(readings, ref, [n for n in limits if n != 'spec_departures'])
    numbers['spec_departures'] = float(len(run.departures))
    correct, table = check.judge(numbers, limits)
    result['correct'] = bool(correct and cell.limits and failed == 0)
    log(f"check of {name}, seed {seed}: program loss {readings['loss']}, "
        f"reference loss {ref['loss']}; worst leaves {worst}; departures {run.departures}; "
        f"numbers {numbers}")
    for n, row in table.items():
        log(f"check {n} {row['value']!r} limit {row['limit']!r}")
    result['check'] = table
    return result
