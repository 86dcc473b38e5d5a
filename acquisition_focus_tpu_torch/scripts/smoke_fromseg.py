"""The from-segmented smoke run at spat 32 (the port's twin of ``scripts/smoke_e2e.py``
with a segmenter, the recipe of ``artifacts/from_segmented_smoke_r02/README.md``):

    python -m acquisition_focus_tpu_torch.scripts.smoke_fromseg --out_dir OUT \
        [--seed 0] [--device cpu]

1. writes 6 phantom cases at 64^3 (1.5 mm) under ``OUT/phantom_data``;
2. trains the segmenter with ``scripts.train_segmenter`` (``--spat 32 --epochs 12
   --steps_per_epoch 40 --batch 8 --multires --seed SEED``);
3. builds the training cases with ``clinical_view_affine_type`` 'from-segmented'
   (the build gate at its default) and 'from-gt', and prints per case and view the
   rotation and translation gap between the two sets of input view affines; builds
   the test cases from-segmented;
4. runs the stage sweep through ``main.main`` on the smoke config (views p2CH and
   p4CH, 32^3 at 48 mm, float32, epochs 2, debug, fold 0) with the segmenter.

Writes ``OUT/summary.json``: the segmenter's training, each case's prescan Dice and
HD95, the gaps, and the sweep's per-stage scores. Where a case fails the build gate,
the summary records it, and the gaps and the sweep come from builds with the gate
lowered, which the summary and the output say.
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np


def smoke_config(data_dir, root, spat=32, views=('p2CH', 'p4CH')):
    fov = float(spat) * 1.5
    return dict(
        dataset=['synthetic', str(data_dir)],
        epochs=2, batch_size=1, num_grad_accum_steps=2, val_batch_size=1,
        base_views=list(views),
        hires_fov_mm=[fov] * 3, hires_fov_vox=[spat] * 3,
        slice_fov_mm=[fov, fov, 1.5], slice_fov_vox=[spat, spat, 1],
        prescan_fov_mm=[fov] * 3, prescan_fov_vox=[spat] * 3,
        num_folds=3, fold_override=0, debug=True,
        compute_dtype='float32', num_sa_slices=3,
        log_dir=str(root / 'runs'), mdl_save_prefix=str(root / 'models'),
        metrics_every=1000, use_caching=False)


def affine_gaps(ds_seg, ds_gt, views):
    """Per case and view: the rotation (degrees) and the translation between the
    segmented-prescan and the GT input view affines, as ``scripts/smoke_e2e.py``
    reports them."""
    out = {}
    for cid in sorted(ds_seg.cases):
        a, b = (np.asarray(d.cases[cid]['input_view_affines'], np.float64)
                for d in (ds_seg, ds_gt))
        for v, name in enumerate(views):
            ra, rb = (r / np.linalg.norm(r, axis=0, keepdims=True)
                      for r in (a[v, :3, :3], b[v, :3, :3]))
            cos = (np.trace(rb.T @ ra) - 1) / 2
            ang = float(np.degrees(np.arccos(np.clip(cos, -1, 1))))
            dt = float(np.linalg.norm(a[v, :3, 3] - b[v, :3, 3]))
            q = ds_seg.cases[cid]['prescan_quality']
            print(f"  {cid} {name}: rot {ang:6.2f} deg, trans {dt:.4f} "
                  f"(prescan dice {q['dice_mean']:.3f})")
            out[f'{cid} {name}'] = {'rot_deg': ang, 'trans': dt}
    return out


def build_gated(cls, data_dir, cfg, state, device):
    """``load_or_build`` of ``state``; where a case fails the build gate, the
    failure and a build with the gate lowered in ``cfg`` (min_prescan_dice 0,
    max_prescan_hd95_mm 1e9), for the report only."""
    from acquisition_focus_tpu_torch.data.cache import load_or_build
    from acquisition_focus_tpu_torch.engine.config import load_config
    try:
        return load_or_build(cls, data_dir, load_config(overrides=dict(cfg)), state,
                             device=device), None
    except RuntimeError as e:
        if 'build gate' not in str(e):
            raise
        print(f"build gate failed: {e}\nbuilding again with min_prescan_dice=0 and "
              f"max_prescan_hd95_mm=1e9, for the report only")
        cfg.update(min_prescan_dice=0.0, max_prescan_hd95_mm=1e9)
        return load_or_build(cls, data_dir, load_config(overrides=dict(cfg)), state,
                             device=device), str(e)


def build_both(data_dir, cfg, device):
    """The training cases built from-segmented and from-gt, and the test cases
    from-segmented, and the first build gate failure (or None)."""
    from acquisition_focus_tpu_torch.data.cache import load_or_build
    from acquisition_focus_tpu_torch.data.mrxcat import get_dataset_class
    from acquisition_focus_tpu_torch.engine.config import load_config
    cls = get_dataset_class(cfg['dataset'][0])
    ds_seg, failure = build_gated(cls, data_dir, cfg, 'train', device)
    ds_gt = load_or_build(cls, data_dir, load_config(overrides={
        **cfg, 'clinical_view_affine_type': 'from-gt', 'segment_model_path': None}),
        'train', device=device)
    ds_test, test_failure = build_gated(cls, data_dir, cfg, 'test', device)
    return ds_seg, ds_gt, ds_test, failure or test_failure


def main(argv=None):
    from acquisition_focus_tpu_torch import main as cli
    from acquisition_focus_tpu_torch.data.synthetic import write_phantom_dataset
    from acquisition_focus_tpu_torch.engine.train import resolve_device
    from acquisition_focus_tpu_torch.scripts import train_segmenter

    p = argparse.ArgumentParser()
    p.add_argument('--out_dir', required=True)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None, help='torch device (default: the card)')
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    root = Path(args.out_dir).resolve()
    data_dir = root / 'phantom_data'
    t_start = time.perf_counter()
    if not (data_dir / 'metadata/data_split.json').exists():
        write_phantom_dataset(data_dir, n_cases=6, shape=(64, 64, 64))

    t0 = time.perf_counter()
    ckpt = root / 'segmenter.pt'
    seg_train = train_segmenter.main([
        '--data_dir', str(data_dir), '--out', str(ckpt), '--dataset', 'synthetic',
        '--spat', '32', '--epochs', '12', '--steps_per_epoch', '40', '--batch', '8',
        '--multires', '--seed', str(args.seed), '--cache_dir', str(root / 'cache'),
        '--device', str(device)])
    seg_train['wall_s'] = time.perf_counter() - t0

    cfg = smoke_config(data_dir, root)
    # view planning affines from the segmenter's prescan segmentation; no output
    # transpose: the checkpoint is in-framework
    cfg.update(clinical_view_affine_type='from-segmented', segment_model_path=str(ckpt),
               segment_extra_permute=False)
    t0 = time.perf_counter()
    ds_seg, ds_gt, ds_test, gate_failure = build_both(data_dir, cfg, device)
    print("input-affine gap (segmented prescan vs GT):")
    gaps = affine_gaps(ds_seg, ds_gt, cfg['base_views'])
    build_s = time.perf_counter() - t0
    quality = {cid: {k: c['prescan_quality'][k] for k in ('dice_mean', 'hd95_mean')}
               for ds in (ds_seg, ds_test) for cid, c in ds.cases.items()}

    cfg_path = root / 'config.json'
    cfg_path.write_text(json.dumps(cfg))
    t0 = time.perf_counter()
    sweep_failure = None
    try:
        cli.main(['--config_path', str(cfg_path), '--base_dir', str(root)], device=device)
    except RuntimeError as e:
        if 'build gate' not in str(e):
            raise
        sweep_failure = str(e)
        print(f"sweep stopped at the build gate: {e}")
    sweep_s = time.perf_counter() - t0

    stages = {}
    for run in sorted((root / 'runs').glob('*_stage-*')):
        recs = [json.loads(line) for line in (run / 'metrics.jsonl').read_text().splitlines()]
        stages[run.name.split('_stage-')[-1]] = {
            k: [r[k] for r in recs if k in r][-1]
            for k in ('losses/train_loss', 'losses/val_loss',
                      'scores/val_mean_oa_exclude_bg_dice',
                      'scores/test_mean_oa_exclude_bg_dice')
            if any(k in r for r in recs)}
    summary = {
        'seed': args.seed, 'device': str(device),
        'segmenter': seg_train, 'prescan_quality': quality,
        'gate': {k: cfg.get(k) for k in ('min_prescan_dice', 'max_prescan_hd95_mm')},
        'gate_failure': gate_failure, 'sweep_gate_failure': sweep_failure,
        'input_affine_gaps': gaps, 'build_both_s': build_s, 'sweep_s': sweep_s,
        'stages': stages, 'wall_s': time.perf_counter() - t_start}
    (root / 'summary.json').write_text(json.dumps(summary, indent=1, default=float))
    print(f"SMOKE OK; summary in {root / 'summary.json'}")
    return summary


if __name__ == '__main__':
    main()
