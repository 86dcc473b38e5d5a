"""The port's own copy of the JAX package's ``utils/logging.py`` (plain Python;
tests hold the ``metrics.jsonl`` lines equal to the original's).

Run logging: wandb-compatible metric naming, JSONL file sink, stdout echo.

The reference logs through wandb (log_utils.py:26-47) with names like
``scores/{phase}_mean_dice_{tag}`` and a fold-encoded global step
(log_utils.py:10-16). Here the same names/steps go to a JSONL file per run (wandb is
not available in the deployment image; if installed and enabled it is used too).
"""

import json
import math
import time
from pathlib import Path

try:
    import wandb as _wandb
except ImportError:  # pragma: no cover
    _wandb = None


def get_global_idx(fold_idx, epoch_idx, max_epochs):
    """fold*10^ceil5(digits) + epoch (reference log_utils.py:10-16)."""
    def ceil5(x, base=5):
        return base * math.ceil(x / base)
    fold_idx = max(0, fold_idx)
    return 10 ** ceil5(len(str(int(max_epochs)))) * fold_idx + epoch_idx


def get_fold_postfix(fold_properties):
    fold_idx = fold_properties[0]
    return f'fold-{fold_idx}' if fold_idx != -1 else ""


class RunLogger:
    def __init__(self, log_dir, run_name, wandb_mode='disabled', config=None):
        self.run_name = run_name
        self.dir = Path(log_dir) / run_name
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / 'metrics.jsonl', 'a')
        self.use_wandb = (_wandb is not None and wandb_mode == 'online')
        if self.use_wandb:
            _wandb.init(project='acquisition_focus_tpu', name=run_name,
                        config=dict(config or {}))
        if config is not None:
            with open(self.dir / 'config.json', 'w') as f:
                json.dump({k: v for k, v in config.items()}, f, indent=2, default=str)

    def log(self, metrics: dict, step: int):
        rec = {'step': step, 'time': time.time(), **metrics}
        self._f.write(json.dumps(rec, default=float) + '\n')
        self._f.flush()
        if self.use_wandb:
            _wandb.log(metrics, step=step)

    def log_label_metrics(self, prefix, metrics_per_label, step, selected=()):
        flat = {}
        for m_name, m_dict in metrics_per_label.items():
            for tag, val in m_dict.items():
                flat[f'{prefix}_{m_name}_{tag}'] = val
        self.log(flat, step)
        for m_name in selected:
            for tag, val in metrics_per_label.get(m_name, {}).items():
                print(f'{prefix}_{m_name}_{tag} {val:.3f}')

    def log_oa_metrics(self, prefix, metrics, step, selected=()):
        self.log({f'{prefix}_{m}': v for m, v in metrics.items()}, step)
        for m in selected:
            if m in metrics:
                print(f'{prefix}_{m} {metrics[m]:.3f}')

    def finish(self):
        self._f.close()
        if self.use_wandb:
            _wandb.finish()
