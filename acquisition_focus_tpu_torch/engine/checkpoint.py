"""Checkpointing (torch port of ``acquisition_focus_tpu/engine/checkpoint.py``):
one file per save holding the whole training state, written atomically.

The JAX package writes an orbax pytree directory per save; the port writes a
``torch.save`` file under the same path names (``{run_name}_best``, ``_epx{n}``,
``_pause``). Its loaders also read the JAX package's orbax directories, through
``engine/orbax_import.py`` (which needs ``tensorstore``).

A run on a device mesh keeps this format: :func:`gather_module_state` and
:func:`gather_optimizer_state` gather the feature-split U-Net parameters and
AdamW's moments to full tensors for the save, and :func:`load_sharded_state`
slices a full state_dict for a split model (the runner restores into the full
model and then splits it, ``parallel.shard_params`` / ``shard_opt_state``), so
checkpoints move between a mesh and one device either way.
"""

import os
from pathlib import Path

import torch

from acquisition_focus_tpu_torch.engine import orbax_import
from acquisition_focus_tpu_torch.parallel.collectives import model_gather
from acquisition_focus_tpu_torch.parallel.mesh import shard_opt_state, slice_state_dict


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


def load_optimizer(opt, sched, module, opt_state, sched_state, split=None, mesh=None):
    """Restore an (optimizer, scheduler) pair over ``module``'s parameters from a
    checkpoint's states: the port's own ``state_dict``s, or the moments and
    counts imported from an optax state (``engine/orbax_import.py``). Those keep
    the optimizer's hyperparameters and set the scheduler, and each group's rate,
    to the imported count. ``split``/``mesh``: ``module`` is split over a mesh's
    'model' axis (``parallel.shard_params``) and the full moments are sliced."""
    if 'moments' not in opt_state:
        opt.load_state_dict(opt_state)
        sched.load_state_dict(sched_state)
        shard_opt_state(opt, module, split, mesh)
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
    shard_opt_state(opt, module, split, mesh)


def gather_module_state(module, split, mesh):
    """``module.state_dict()`` with every parameter that ``split`` ({name: axis},
    from ``parallel.shard_params``) names gathered over 'model' to its full
    tensor. A collective: every rank of the mesh calls it."""
    sd = module.state_dict()
    if not split:
        return sd
    return {k: model_gather(v, mesh, split[k]) if k in split else v for k, v in sd.items()}


def gather_optimizer_state(opt, module, split, mesh):
    """``opt.state_dict()`` with the moments (``exp_avg``, ``exp_avg_sq``) of
    ``module``'s split parameters gathered to full tensors. A collective."""
    sd = opt.state_dict()
    if not split:
        return sd
    names = {id(p): n for n, p in module.named_parameters()}
    order = [names.get(id(p)) for group in opt.param_groups for p in group['params']]
    state = {}
    for i, st in sd['state'].items():
        dim = split.get(order[i])
        state[i] = st if dim is None else {
            k: model_gather(v, mesh, dim) if k in ('exp_avg', 'exp_avg_sq') else v
            for k, v in st.items()}
    return dict(sd, state=state)


def load_sharded_state(module, state_dict, split, mesh):
    """Load a full (one-device) state_dict into a module whose ``split``
    parameters hold this rank's slices."""
    module.load_state_dict(slice_state_dict(state_dict, split, mesh) if split
                           else state_dict)
