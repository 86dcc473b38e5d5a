"""The port's own copy of the JAX package's ``utils/results.py`` (pandas, no jax;
tests hold the tables equal).

Run-result aggregation: metrics.jsonl -> summary tables.

Replaces the reference's wandb-API result notebooks
(the reference's visualize/get_run_data.ipynb: pandas tables of per-label dice/HD95
across runs/folds/stages) with a local aggregation over the JSONL sinks that
``utils.logging.RunLogger`` writes.
"""

import json
from pathlib import Path

import pandas as pd


def load_run_metrics(run_dir):
    """One run's metrics.jsonl -> long-form DataFrame (step, metric, value)."""
    rows = []
    with open(Path(run_dir) / 'metrics.jsonl') as f:
        for line in f:
            rec = json.loads(line)
            step = rec.pop('step', None)
            rec.pop('time', None)
            for k, v in rec.items():
                if isinstance(v, (int, float)):
                    rows.append({'run': Path(run_dir).name, 'step': step,
                                 'metric': k, 'value': v})
    return pd.DataFrame(rows)


def summarize_runs(log_dir, metric_filter='scores/test_mean', last_only=True):
    """All runs under log_dir -> wide table of final test metrics per run."""
    frames = []
    for run_dir in sorted(Path(log_dir).iterdir()):
        if not (run_dir / 'metrics.jsonl').exists():
            continue
        df = load_run_metrics(run_dir)
        df = df[df.metric.str.startswith(metric_filter)]
        if df.empty:
            continue
        if last_only:
            df = df.sort_values('step').groupby('metric', as_index=False).last()
            df['run'] = run_dir.name
        frames.append(df)
    if not frames:
        return pd.DataFrame()
    all_df = pd.concat(frames)
    return all_df.pivot_table(index='run', columns='metric', values='value')


def dice_table(log_dir, label_tags=('MYO', 'LV', 'RV', 'LA', 'RA')):
    """Per-class test dice per run — the reference's headline ablation table shape
    (get_run_data.ipynb cells 11/20)."""
    wide = summarize_runs(log_dir, 'scores/test_mean_dice')
    cols = {f'scores/test_mean_dice_{t}': t for t in label_tags}
    present = {k: v for k, v in cols.items() if k in wide.columns}
    table = wide[list(present)].rename(columns=present)
    oa = summarize_runs(log_dir, 'scores/test_mean_oa_exclude_bg_dice')
    if not oa.empty:
        table['overall'] = oa.iloc[:, 0]
    return table


def cross_fold_table(log_dir, label_tags=('MYO', 'LV', 'RV', 'LA', 'RA')):
    """Per-stage mean/std across CV folds of the final test dice — the
    reference's cross-fold ablation aggregation (wandb groupby in
    get_run_data.ipynb cells 11-13, fed by the 3-fold loop of
    main_acquisition_focus.py:143-176). Run-dir names must carry the
    ``_fold-N`` and (for sweeps) ``_stage-X`` postfixes that
    utils.logging/get_fold_postfix and the stage machinery encode."""
    per_run = dice_table(log_dir, label_tags)
    if per_run.empty:
        return per_run, per_run
    idx = per_run.index.to_series()
    fold = idx.str.extract(r'_fold-(\d+)')[0]
    stage = idx.str.extract(r'_stage-(.+)$')[0].fillna('main')
    per_run = per_run.assign(fold=fold.values, stage=stage.values)
    g = per_run.groupby('stage')[list(per_run.columns[:-2])]
    return g.mean(), g.std(ddof=0)


if __name__ == '__main__':
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('--log_dir', default='data/runs')
    p.add_argument('--cross_fold', action='store_true',
                   help='aggregate mean/std across _fold-N runs per stage')
    args = p.parse_args()
    if args.cross_fold:
        mean, std = cross_fold_table(args.log_dir)
        print('== mean across folds ==')
        print(mean.to_string())
        print('== std across folds ==')
        print(std.to_string())
    else:
        print(dice_table(args.log_dir).to_string())
