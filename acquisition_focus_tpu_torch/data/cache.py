"""The port's own copy of the JAX package's ``data/cache.py``: the key and the file
format are the same, so a cache either package wrote loads in the other (tests hold
both; the centroid fits of the two differ, ``PARITY.md``). A miss builds the dataset
on ``device`` (the card unless the caller passes ``device='cpu'``).

Content-hash dataset caching: build once per (config, data) fingerprint.

Replaces the reference's dill+joblib cache keyed on argument hash + git commit
(main_acquisition_focus.py:28-59) with a pickle keyed on the config keys that shape
the precompute plus the data split file content.
"""

import hashlib
import json
import pickle
from pathlib import Path

_CACHE_KEYS = (
    'hires_fov_mm', 'hires_fov_vox', 'prescan_fov_mm', 'prescan_fov_vox',
    'clinical_view_affine_type', 'use_binarized_labels', 'base_views',
    'num_sa_slices', 'seed', 'centroid_ref_path', 'segment_model_path',
    'segment_extra_permute',
)


def _build(dataset_cls, data_base_dir, config, state, debug, *, device=None):
    """Construct + load a dataset, wiring the frozen segmenter BEFORE the load so
    from-segmented precompute actually segments (reference base_dataset.py:44
    calls set_segment_fn(fold_idx=0) at __init__ before load_data)."""
    ds = dataset_cls(data_base_dir, config, state='empty', debug=debug, device=device)
    if config.get('clinical_view_affine_type') == 'from-segmented':
        ds.set_segment_fn(fold_idx=0)
    ds.state = state
    if state != 'empty':
        ds._load()
    return ds


def _fingerprint(data_base_dir, config, state):
    payload = {k: config.get(k) for k in _CACHE_KEYS}
    payload['state'] = state
    payload['dir'] = str(data_base_dir)
    split = Path(data_base_dir) / 'metadata/data_split.json'
    if split.is_file():
        payload['split'] = hashlib.sha256(split.read_bytes()).hexdigest()
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()[:16]


def load_or_build(dataset_cls, data_base_dir, config, state, cache_dir='.cache',
                  debug=False, *, device=None):
    if not config.get('use_caching', True) or state == 'empty':
        return _build(dataset_cls, data_base_dir, config, state, debug, device=device)

    cache_path = Path(cache_dir) / (
        f"{dataset_cls.__name__}_{_fingerprint(data_base_dir, config, state)}.pkl")
    if cache_path.is_file():
        with open(cache_path, 'rb') as f:
            cases = pickle.load(f)
        ds = dataset_cls(data_base_dir, config, state='empty', debug=debug,
                         device=device)
        ds.state = state
        ds.cases = cases
        return ds

    ds = _build(dataset_cls, data_base_dir, config, state, debug, device=device)
    cache_path.parent.mkdir(parents=True, exist_ok=True)
    with open(cache_path, 'wb') as f:
        pickle.dump(ds.cases, f)
    return ds
