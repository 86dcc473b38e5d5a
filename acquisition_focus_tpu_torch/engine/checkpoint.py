"""Checkpointing (torch port of ``acquisition_focus_tpu/engine/checkpoint.py``):
one file per save holding the whole training state, written atomically.

The JAX package writes an orbax pytree directory per save; the port writes a
``torch.save`` file under the same path names (``{run_name}_best``, ``_epx{n}``,
``_pause``). Its loaders also read the JAX package's orbax directories, through
``engine/orbax_import.py`` (which needs ``tensorstore``).
"""

import os
from pathlib import Path

import torch

from acquisition_focus_tpu_torch.engine import orbax_import


def save_checkpoint(path, state):
    """Save ``state`` (a dict of state_dicts and numbers) to the file ``path``:
    written to a temporary file beside it, then moved over it."""
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f'.{path.name}.{os.getpid()}.tmp')
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, map_location='cpu'):
    """Load a checkpoint saved by :func:`save_checkpoint`, or import an orbax
    checkpoint directory of the JAX package into the same contents; tensors land
    on ``map_location`` (``load_state_dict`` moves them to the module's device)."""
    path = Path(path).resolve()
    if orbax_import.is_orbax_checkpoint(path):
        return orbax_import.import_checkpoint(path)
    return torch.load(path, map_location=map_location, weights_only=True)


def checkpoint_exists(path):
    """A checkpoint file, or an orbax checkpoint directory of the JAX package. A
    missing path or an empty directory holds none; any other directory raises,
    so that a run never starts afresh beside a checkpoint it cannot read."""
    path = Path(path)
    if not path.is_dir():
        return path.is_file()
    if orbax_import.is_orbax_checkpoint(path):
        return True
    if any(path.iterdir()):
        raise ValueError(f"{path} is a directory but no orbax checkpoint (no _METADATA)")
    return False


def load_optimizer(opt, sched, module, opt_state, sched_state):
    """Restore an (optimizer, scheduler) pair over ``module``'s parameters from a
    checkpoint's states: the port's own ``state_dict``s, or the moments and
    counts imported from an optax state (``engine/orbax_import.py``). Those keep
    the optimizer's hyperparameters and set the scheduler, and each group's rate,
    to the imported count."""
    if 'moments' not in opt_state:
        opt.load_state_dict(opt_state)
        sched.load_state_dict(sched_state)
        return
    names = {id(p): n for n, p in module.named_parameters()}
    order = [names[id(p)] for group in opt.param_groups for p in group['params']]
    opt.load_state_dict({'state': {i: opt_state['moments'][n] for i, n in enumerate(order)},
                         'param_groups': opt.state_dict()['param_groups']})
    count = sched_state['last_epoch']
    lrs = [base * fn(count) for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
    sched.load_state_dict(dict(sched.state_dict(), last_epoch=count, _step_count=count + 1,
                               _last_lr=lrs))
    for group, lr in zip(opt.param_groups, lrs):
        group['lr'] = lr
