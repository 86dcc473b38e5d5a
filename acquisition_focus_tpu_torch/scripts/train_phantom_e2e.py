"""Full end-to-end phantom training of the port (twin of
``scripts/train_phantom_e2e.py``):

    python -m acquisition_focus_tpu_torch.scripts.train_phantom_e2e \
        [--single_stage] [--binarized] [--model_type hybrid-EPix2Vox] \
        [--batch 1 --accum 4] [--out_dir artifacts/torch_e2e_x] [--device cpu] \
        [--no_tf32]

Writes a phantom dataset (14 cases at 96^3 by default), trains through the port's
CLI (``main.main`` with ``--config_path``) at the reference geometry (128^3 @
192 mm, bf16 U-Net compute, batch 2 x accum 2) and collects the small artifacts
under ``--out_dir``:

- ``metrics_stage-*.jsonl``: the per-stage metric streams (loss and Dice curves);
- ``summary.json``: final per-class train/val/test Dice, losses, per-stage epoch
  seconds, the wall and, on the card, the peak device memory;
- ``affines_final.pkl``: the learned per-view affines of the last dumped epoch;
- ``training_curves.png``, ``learned_planes.png``: rendered with matplotlib where
  it is installed; ``--plot_only`` renders them later from the artifacts, with the
  same arguments as the run (the planes figure builds its case on ``--device``).

The phantom data, the run logs and the checkpoints (about 1 GB each) stay under
``.cache/torch_e2e/`` (git-ignored); only the artifacts above go to ``--out_dir``.
Everything runs on the card unless ``--device cpu`` (or ``--cpu``) is given.
"""

import argparse
import json
import pickle
import shutil
import time
from pathlib import Path

import torch

from acquisition_focus_tpu_torch import main as cli
from acquisition_focus_tpu_torch.data.synthetic import write_phantom_dataset
from acquisition_focus_tpu_torch.engine.train import EPIX2VOX_TYPES, resolve_device

REPO = Path(__file__).resolve().parents[2]
RUN_DIR = REPO / '.cache' / 'torch_e2e'
VIEWS = ('p2CH', 'p4CH', 'SA-7')


def make_config(run_root, data_dir, epochs=40, views=VIEWS, spat=128,
                compute_dtype='bfloat16', fov_mult=1.5, base_features=None,
                locnet_width=None, model_type=None, single_stage=False, all_folds=False,
                binarized=False, batch_size=2, accum=2, metrics_every=5, prescan=None,
                theta_refresh=1, seed=0):
    """The run's config, key for key the JAX script's. fov_mult: mm per output
    voxel (1.5 at spat 128 is the reference's 192 mm FOV; a smaller spat needs a
    larger one so the ~110 mm phantom heart fits)."""
    fov = float(spat) * float(fov_mult)
    cfg = dict(
        dataset=['synthetic', str(data_dir)],
        epochs=epochs, batch_size=batch_size, num_grad_accum_steps=accum,
        val_batch_size=1,
        base_views=list(views),
        hires_fov_mm=[fov] * 3, hires_fov_vox=[spat] * 3,
        slice_fov_mm=[fov, fov, 1.5], slice_fov_vox=[spat, spat, 1],
        prescan_fov_mm=[fov] * 3, prescan_fov_vox=[spat] * 3,
        num_folds=3, fold_override=0,
        compute_dtype=compute_dtype, num_sa_slices=15,
        log_dir=str(run_root / 'runs'), mdl_save_prefix=str(run_root / 'models'),
        metrics_every=metrics_every, save_every='best', do_output=True,
        use_caching=True,
        # stage-granular resume on relaunch (main.stage_sweep_run)
        sweep_state_path=str(run_root / 'sweep_state.json'),
    )
    if prescan is not None:
        cfg['prescan_fov_vox'] = [int(prescan)] * 3
    if theta_refresh and int(theta_refresh) > 1:
        cfg['theta_refresh_every'] = int(theta_refresh)
    cfg['seed'] = int(seed)
    if base_features is not None:
        cfg['base_features'] = list(base_features)
    if locnet_width is not None:
        cfg['locnet_width'] = int(locnet_width)
    if model_type is not None:
        cfg['model_type'] = model_type
        if model_type in EPIX2VOX_TYPES:
            # the (E)Pix2Vox baselines emit background/foreground occupancy; the
            # reference runs them only with binarized labels
            binarized = True
    if binarized:
        cfg['use_binarized_labels'] = True
    if all_folds:
        cfg['fold_override'] = None
    if single_stage:
        # one fixed-view training run (the related-works comparison protocol)
        cfg['sweep_type'] = None
        cfg['view_optimization_mode'] = 'opt-none'
        cfg['use_affine_theta'] = False
    return cfg


def run(epochs=40, n_cases=14, views=VIEWS, spat=128, data_dir=None, out_dir=None,
        compute_dtype='bfloat16', fov_mult=1.5, base_features=None, locnet_width=None,
        model_type=None, single_stage=False, all_folds=False, binarized=False,
        batch_size=2, accum=2, metrics_every=5, prescan=None, theta_refresh=1, seed=0,
        device=None, run_dir=None):
    """Train through the port's CLI and collect the artifacts; returns the summary.
    ``device``: ``None`` is the card (see ``engine.train.resolve_device``);
    ``run_dir``: where the phantom data (unless ``data_dir``), the run roots and
    the checkpoints go (default ``.cache/torch_e2e``)."""
    device = resolve_device(device)
    run_dir = Path(run_dir or RUN_DIR)
    data_dir = Path(data_dir or run_dir / 'phantom_data')
    out_dir = Path(out_dir or REPO / 'artifacts' / 'torch_e2e_phantom')
    run_root = run_dir / f'{out_dir.name}_run'
    run_root.mkdir(parents=True, exist_ok=True)

    if not (data_dir / 'metadata/data_split.json').exists():
        print('writing phantom dataset ...', flush=True)
        write_phantom_dataset(data_dir, n_cases=n_cases, shape=(96, 96, 96))

    cfg = make_config(run_root, data_dir, epochs, views, spat, compute_dtype, fov_mult,
                      base_features, locnet_width, model_type, single_stage, all_folds,
                      binarized, batch_size, accum, metrics_every, prescan,
                      theta_refresh, seed)
    cfg_path = run_root / 'config.json'
    cfg_path.write_text(json.dumps(cfg))

    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cli.main(['--config_path', str(cfg_path), '--base_dir', str(run_root)], device=device)
    wall = time.time() - t0
    print(f'run done in {wall / 60:.1f} min', flush=True)
    peak = torch.cuda.max_memory_allocated() if device.type == 'cuda' else None
    return collect_artifacts(run_root, out_dir, wall, peak, device)


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def collect_artifacts(run_root, out_dir, wall_s=None, peak_memory_bytes=None,
                      device='cpu'):
    """Copy the metric streams and the last dumped affines of ``run_root`` into
    ``out_dir``, write ``summary.json`` (the JAX script's keys, plus per-stage
    epoch seconds, per-class train/val Dice and the peak memory) and render the
    figures where matplotlib is installed. Returns the summary."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    run_dirs = sorted((Path(run_root) / 'runs').glob('*_stage-*'))
    if not run_dirs:            # single-stage run: one unsuffixed run dir
        run_dirs = sorted((Path(run_root) / 'runs').glob('*_fold-*'))
    folds = {rd.name.split('_fold-')[-1].split('_')[0] for rd in run_dirs
             if '_fold-' in rd.name}
    stages = {}
    for rd in run_dirs:
        stage = rd.name.split('_stage-')[-1] if '_stage-' in rd.name else 'main'
        if len(folds) > 1:      # 3-fold CV: one stream per (fold, stage)
            stage = f"fold{rd.name.split('_fold-')[-1].split('_')[0]}-{stage}"
        if (rd / 'metrics.jsonl').exists():
            stages[stage] = _read_jsonl(rd / 'metrics.jsonl')
            shutil.copy(rd / 'metrics.jsonl', out_dir / f'metrics_stage-{stage}.jsonl')

    for rd in reversed(run_dirs):
        pkls = (sorted(rd.glob('output/val/affines_*.pkl'))
                or sorted(rd.glob('output/*/affines_*.pkl')))
        if pkls:
            shutil.copy(pkls[-1], out_dir / 'affines_final.pkl')
            break

    summary = {'wall_s': wall_s, 'peak_memory_bytes': peak_memory_bytes,
               'device': (torch.cuda.get_device_name(torch.device(device))
                          if torch.device(device).type == 'cuda' else 'cpu'),
               'stages': {}}
    for stage, recs in stages.items():
        final = {k: v for rec in recs for k, v in rec.items()
                 if k.startswith(('losses/', 'scores/'))}     # each metric's last value

        def per_class(split):
            return {k.rsplit('_', 1)[-1]: v for k, v in final.items()
                    if k.startswith(f'scores/{split}_mean_dice_')}

        epoch_s = [r['perf/epoch_s'] for r in recs if 'perf/epoch_s' in r]
        summary['stages'][stage] = {
            'final_train_loss': final.get('losses/train_loss'),
            'final_val_loss': final.get('losses/val_loss'),
            'final_val_dice_oa': final.get('scores/val_mean_oa_exclude_bg_dice'),
            'final_test_dice_oa': final.get('scores/test_mean_oa_exclude_bg_dice'),
            'final_test_dice_per_class': per_class('test'),
            'final_train_dice_per_class': per_class('train'),
            'final_val_dice_per_class': per_class('val'),
            'epochs': len(epoch_s),
            'mean_epoch_s': sum(epoch_s) / len(epoch_s) if epoch_s else None,
        }
    (out_dir / 'summary.json').write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    try:
        plot_artifacts(out_dir, json.loads((Path(run_root) / 'config.json').read_text()),
                       device)
    except Exception as e:  # rendering must never sink the artifact pass
        print(f'figures not rendered: {e!r}')
    return summary


def plot_artifacts(out_dir, cfg, device='cpu'):
    """``training_curves.png`` from the metric streams in ``out_dir`` and
    ``learned_planes.png`` from ``affines_final.pkl``: the learned planes in the
    first dumped case, built again from the phantom files of ``cfg``'s dataset."""
    from acquisition_focus_tpu_torch.data.cache import load_or_build
    from acquisition_focus_tpu_torch.data.mrxcat import get_dataset_class
    from acquisition_focus_tpu_torch.engine.config import load_config
    from acquisition_focus_tpu_torch.utils.visualize import (
        plot_learned_planes, plot_training_curves)

    out_dir = Path(out_dir)
    stages = {p.stem.split('metrics_stage-', 1)[1]: _read_jsonl(p)
              for p in sorted(out_dir.glob('metrics_stage-*.jsonl'))}
    plot_training_curves(stages, out_dir / 'training_curves.png')
    print(f"wrote {out_dir / 'training_curves.png'}")
    if not (out_dir / 'affines_final.pkl').exists():
        return
    with open(out_dir / 'affines_final.pkl', 'rb') as f:
        affines = pickle.load(f)
    cfg = load_config(overrides=cfg)
    ds = load_or_build(get_dataset_class(cfg['dataset'][0]), cfg['dataset'][1], cfg,
                       state='train', device=device)
    case_id = next(cid for cid in affines if cid in ds.cases)
    case = ds.cases[case_id]
    plot_learned_planes(case['label'], case['nii_affine'], affines[case_id],
                        out_dir / 'learned_planes.png',
                        view_names=list(cfg['base_views']),
                        slice_shape=tuple(cfg['slice_fov_vox'][:2]))
    print(f"wrote {out_dir / 'learned_planes.png'} (case {case_id})")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--epochs', type=int, default=40)
    p.add_argument('--spat', type=int, default=128)
    p.add_argument('--fov_mult', type=float, default=1.5)
    p.add_argument('--n_cases', type=int, default=14)
    p.add_argument('--views', nargs='*', default=None, help='base view names')
    p.add_argument('--base_features', type=int, nargs='*', default=None)
    p.add_argument('--locnet_width', type=int, default=None)
    p.add_argument('--model_type', default=None,
                   help='hybrid-unet (default) | hybrid-EPix2Vox | hybrid-Pix2Vox')
    p.add_argument('--single_stage', action='store_true',
                   help='skip the stage sweep: one fixed-view training run')
    p.add_argument('--all_folds', action='store_true',
                   help='run the full 3-fold CV instead of fold 0 only')
    p.add_argument('--binarized', action='store_true',
                   help='use_binarized_labels (forced on for (E)Pix2Vox)')
    p.add_argument('--batch', type=int, default=2, help='microbatch size')
    p.add_argument('--accum', type=int, default=2)
    p.add_argument('--compute_dtype', default='bfloat16')
    p.add_argument('--cpu', action='store_true', help='the same as --device cpu')
    p.add_argument('--device', default=None, help='torch device (default: the card)')
    p.add_argument('--no_tf32', action='store_true',
                   help="full float32 cuDNN convolutions (PyTorch's default allows TF32)")
    p.add_argument('--metrics_every', type=int, default=5,
                   help='heavy val/test metric-epoch cadence (the final epoch always)')
    p.add_argument('--prescan', type=int, default=None,
                   help='prescan/locnet grid (e.g. 64); None = spat')
    p.add_argument('--theta_refresh', type=int, default=1,
                   help='theta-refresh cadence k (config theta_refresh_every)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--data_dir', default=None)
    p.add_argument('--out_dir', default=None)
    p.add_argument('--collect_only', default=None,
                   help='skip training; collect artifacts from this run root')
    p.add_argument('--plot_only', action='store_true',
                   help='skip training; render the figures from --out_dir')
    a = p.parse_args(argv)
    device = 'cpu' if a.cpu else a.device
    out_dir = a.out_dir or REPO / 'artifacts' / 'torch_e2e_phantom'
    views = tuple(a.views) if a.views else VIEWS
    if a.collect_only:
        return collect_artifacts(a.collect_only, out_dir)
    if a.plot_only:
        run_root = RUN_DIR / f'{Path(out_dir).name}_run'
        cfg = make_config(run_root, Path(a.data_dir or RUN_DIR / 'phantom_data'),
                          a.epochs, views, a.spat, a.compute_dtype, a.fov_mult,
                          a.base_features or None, a.locnet_width, a.model_type,
                          a.single_stage, a.all_folds, a.binarized, a.batch, a.accum,
                          a.metrics_every, a.prescan, a.theta_refresh, a.seed)
        data_dir = Path(cfg['dataset'][1])
        if not (data_dir / 'metadata/data_split.json').exists():
            write_phantom_dataset(data_dir, n_cases=a.n_cases, shape=(96, 96, 96))
        return plot_artifacts(out_dir, cfg, resolve_device(device))
    if a.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
    return run(epochs=a.epochs, n_cases=a.n_cases, views=views, spat=a.spat,
               data_dir=a.data_dir, out_dir=a.out_dir, compute_dtype=a.compute_dtype,
               fov_mult=a.fov_mult, base_features=a.base_features or None,
               locnet_width=a.locnet_width, model_type=a.model_type,
               single_stage=a.single_stage, all_folds=a.all_folds,
               binarized=a.binarized, batch_size=a.batch, accum=a.accum,
               metrics_every=a.metrics_every, prescan=a.prescan,
               theta_refresh=a.theta_refresh, seed=a.seed, device=device)


if __name__ == '__main__':
    main()
