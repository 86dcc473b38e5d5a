"""Checkpointing (torch port of ``acquisition_focus_tpu/engine/checkpoint.py``):
one file per save holding the whole training state, written atomically.

The JAX package writes an orbax pytree directory per save; the port writes a
``torch.save`` file under the same path names (``{run_name}_best``, ``_epx{n}``,
``_pause``). Reading the JAX package's orbax checkpoints needs orbax, and so jax,
and is not ported.
"""

import os
from pathlib import Path

import torch


def save_checkpoint(path, state):
    """Save ``state`` (a dict of state_dicts and numbers) to the file ``path``:
    written to a temporary file beside it, then moved over it."""
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f'.{path.name}.{os.getpid()}.tmp')
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, map_location='cpu'):
    """Load a checkpoint saved by :func:`save_checkpoint`; tensors land on
    ``map_location`` (``load_state_dict`` moves them to the module's device)."""
    return torch.load(Path(path).resolve(), map_location=map_location, weights_only=True)


def checkpoint_exists(path):
    return Path(path).is_file()
