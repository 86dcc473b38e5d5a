"""Read the JAX package's orbax checkpoints into the port's state, without JAX.

The JAX package saves with orbax's ``PyTreeCheckpointer``
(``acquisition_focus_tpu/engine/checkpoint.py``): a directory whose ``_METADATA``
holds the tree (each leaf's key path, dict or sequence keys, and value type),
whose arrays and scalars are zarr (or, under ``use_zarr3``, zarr3) arrays in an
OCDBT key-value store, named by the key path joined with '.', and whose strings
are in ``_strings.json``. :func:`read_tree` reads that with ``tensorstore``
alone, imported when called; :func:`import_checkpoint` turns a run's or a
segmenter's tree into what the port's loaders take, through ``convert.py``:

* a run checkpoint (``unet_params``, ``atm_params``, ``recon_opt_leaves``,
  ``trans_opt_leaves``, ``epoch``, ``loss``, ``best_quality``; the JAX runner's
  save) -> ``unet`` / ``atms`` state_dicts, and per optimizer the Adam moments by
  parameter name with optax's update count as ``step`` (``{'moments': ...}``)
  and the schedule's count (``{'last_epoch': n}``), which
  ``engine/checkpoint.py::load_optimizer`` puts into the port's optimizers;
* a segmenter checkpoint (``params``, ``num_classes``) -> the port's segmenter
  file contents.

The optax states are flat leaf lists. ``optax.adamw`` over a schedule is
[count, mu..., nu..., schedule count] (no schedule count with a constant rate),
mu and nu in the params' flattening order (dict keys sorted); the (E)Pix2Vox
optimizer is ``optax.multi_transform`` of two such Adam states, 'main' and then
'merger' (the params under ``params/merger``), each over its own leaves only.
Frozen views' moments are imported as optax left them.

    python -m acquisition_focus_tpu_torch.scripts.import_orbax SRC DST

writes the port's ``torch.save`` file of a checkpoint directory, so that it
converts on any host with ``tensorstore`` and runs where the port does.
"""

import json
from pathlib import Path

import torch

from acquisition_focus_tpu_torch.convert import (
    atm_state_dicts, epix2vox_state_dict, segunet_state_dict, unet_state_dict)

_EMPTY = {'Dict': dict, 'List': list, 'Tuple': tuple, 'None': lambda: None}
_SEQUENCE_KEY = 1            # orbax's key type of a sequence index (2: a dict key)


def is_orbax_checkpoint(path):
    """Whether ``path`` is an orbax checkpoint directory (it holds ``_METADATA``)."""
    return (Path(path) / '_METADATA').is_file()


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading an orbax checkpoint needs the tensorstore package, which is not "
            "installed: convert the checkpoint on a host that has it with `python -m "
            "acquisition_focus_tpu_torch.scripts.import_orbax SRC DST` and pass the "
            "file it writes") from e
    return tensorstore


def _sequences_to_lists(node, sequences):
    if not isinstance(node, dict):
        return node
    items = {k: _sequences_to_lists(v, sequences) for k, v in node.items()}
    return [items[k] for k in sorted(items, key=int)] if id(node) in sequences else items


def read_tree(path):
    """The pytree of an orbax ``PyTreeCheckpointer`` directory: nested dicts and
    lists of numpy arrays, Python scalars, strings and empty containers."""
    ts = _tensorstore()
    path = Path(path).resolve()
    meta = json.loads((path / '_METADATA').read_text())
    if not meta.get('use_ocdbt'):
        raise ValueError(f"{path}: not an OCDBT checkpoint (use_ocdbt false), which the "
                         "JAX package never writes")
    driver = 'zarr3' if meta.get('use_zarr3') else 'zarr'
    strings_file = path / '_strings.json'
    strings = json.loads(strings_file.read_text()) if strings_file.is_file() else {}
    root, sequences = {}, set()
    for entry in meta['tree_metadata'].values():
        keys = entry['key_metadata']
        value_type = entry['value_metadata']['value_type']
        name = '.'.join(k['key'] for k in keys)
        if value_type in ('jax.Array', 'np.ndarray', 'scalar'):
            spec = {'driver': driver, 'path': name,
                    'kvstore': {'driver': 'ocdbt', 'base': f'file://{path}'}}
            value = ts.open(spec, open=True, read=True).result().read().result()
            if value_type == 'scalar':
                value = value.item()
        elif value_type == 'string':
            value = strings[name]
        elif value_type in _EMPTY:
            value = _EMPTY[value_type]()
        else:
            raise ValueError(f"{path}: leaf {name!r} has value type {value_type!r}, "
                             "which the reader does not know")
        # a key's type says what its container is: a dict or a sequence
        node = root
        for k in keys:
            if k['key_type'] == _SEQUENCE_KEY:
                sequences.add(id(node))
            if k is keys[-1]:
                node[k['key']] = value
            else:
                node = node.setdefault(k['key'], {})
    return _sequences_to_lists(root, sequences)


def _leaf_paths(tree, prefix=()):
    """The leaves' key paths in JAX's flattening order: dict keys sorted,
    sequences in order."""
    if isinstance(tree, dict):
        return [path for k in sorted(tree) for path in _leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [path for i, item in enumerate(tree)
                for path in _leaf_paths(item, prefix + (i,))]
    return [prefix]


def _unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in flattening order) in its places."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(item) for item in node]
        return next(it)
    return build(tree)


def _optimizer_state(params, opt_leaves, convert, merger_group=False):
    """Optax Adam leaves over the flax tree ``params`` -> the port's imported
    optimizer and scheduler states. ``convert`` maps a params-shaped tree to the
    port's {name: tensor}. ``merger_group``: two Adam states, 'main' and 'merger'
    (the (E)Pix2Vox optimizer); otherwise one."""
    paths = _leaf_paths(params)
    in_merger = [merger_group and p[:2] == ('params', 'merger') for p in paths]
    groups = [[i for i, m in enumerate(in_merger) if m == g]
              for g in ((False, True) if merger_group else (False,))]
    sizes = [len(g) for g in groups]
    extra = len(opt_leaves) - sum(1 + 2 * n for n in sizes)
    if extra not in (0, len(groups)):
        raise ValueError(f"{len(opt_leaves)} optimizer leaves do not make {len(groups)} "
                         f"optax Adam state(s) over {sizes} param leaves")
    with_schedule = extra > 0
    mu, nu, counts, schedule_counts, pos = [None] * len(paths), [None] * len(paths), [], [], 0
    for idx in groups:
        counts.append(int(opt_leaves[pos]))
        for j, i in enumerate(idx):
            mu[i] = opt_leaves[pos + 1 + j]
            nu[i] = opt_leaves[pos + 1 + len(idx) + j]
        pos += 1 + 2 * len(idx)
        schedule_counts.append(int(opt_leaves[pos]) if with_schedule else counts[-1])
        pos += with_schedule
    exp_avg, exp_avg_sq = convert(_unflatten(params, mu)), convert(_unflatten(params, nu))
    def group_of(name):
        return int(merger_group and name.startswith('merger.'))
    moments = {name: {'step': torch.tensor(float(counts[group_of(name)])),
                      'exp_avg': exp_avg[name], 'exp_avg_sq': exp_avg_sq[name]}
               for name in exp_avg}
    return {'moments': moments}, {'last_epoch': schedule_counts[0]}


def _atms_state_dict(tree):
    return {f'{v}.{k}': t for v, sd in enumerate(atm_state_dicts(tree)) for k, t in sd.items()}


def import_run_checkpoint(tree):
    """A JAX run checkpoint's tree -> the port's run checkpoint contents."""
    unet_params, atm_params = tree['unet_params'], tree['atm_params']
    hybrid = 'seg_head' in unet_params['params']
    convert_unet = unet_state_dict if hybrid else epix2vox_state_dict
    out = {'unet': convert_unet(unet_params), 'atms': _atms_state_dict(atm_params),
           'epoch': int(tree.get('epoch', -1)), 'loss': tree.get('loss'),
           'best_quality': float(tree.get('best_quality', float('inf')))}
    if 'recon_opt_leaves' in tree:
        out['recon_opt'], out['recon_sched'] = _optimizer_state(
            unet_params, tree['recon_opt_leaves'], convert_unet, merger_group=not hybrid)
        out['trans_opt'], out['trans_sched'] = _optimizer_state(
            atm_params, tree['trans_opt_leaves'], _atms_state_dict)
    return out


def import_checkpoint(path):
    """An orbax checkpoint directory of the JAX package -> what the port's
    loaders read from its own files: a run checkpoint (``engine/runner.py``) or
    a segmenter checkpoint (``engine/segmenter.py::load_segmenter``)."""
    tree = read_tree(path)
    if 'unet_params' in tree:
        return import_run_checkpoint(tree)
    if 'params' in tree and 'num_classes' in tree:
        return {'params': segunet_state_dict(tree['params']),
                'num_classes': int(tree['num_classes'])}
    raise ValueError(f"{path}: neither a run checkpoint (unet_params) nor a segmenter "
                     f"checkpoint (params, num_classes) of the JAX package: keys "
                     f"{sorted(tree)}")
