"""Dataset layer, batch half (torch port of the jax-free part of
``acquisition_focus_tpu/data/base_dataset.py``): case ids, batch collation and the
train/eval iterators over numpy cases.

A case is a dict of numpy arrays: 'label' (D, H, W) int, 'image' (D, H, W) float,
'nii_affine' (4, 4) and 'input_view_affines' (V, 4, 4), as the JAX package's build
precomputes them. Building cases from NIfTI files (``_load``: hires resample,
clinical views, centroid registration, prescan) is not ported: the port takes
cases from :meth:`BaseDataset.from_cases`, or from the dataset cache the JAX
package writes, through its jax-free ``data/cache.py::load_or_build`` with this
class as ``dataset_cls`` (a cache miss reaches ``_load`` and raises).
"""

import json
from pathlib import Path

import numpy as np


class BaseDataset:
    label_tags = ("background", "MYO", "LV", "RV", "LA", "RA")

    def __init__(self, data_base_dir, config, state='train', debug=False):
        self.data_base_dir = Path(data_base_dir)
        self.config = config
        self.state = state
        self.debug = debug
        if config.get('use_binarized_labels'):
            self.label_tags = ("background", "foreground")

        with open(self.data_base_dir / "metadata/data_split.json") as f:
            self.data_split = json.load(f)

        self.cases = {}
        if state != 'empty':
            self._load()

    @classmethod
    def from_cases(cls, cases, config, state='train'):
        """A dataset over ready cases ({case_id: case dict}), with no files."""
        ds = cls.__new__(cls)
        ds.data_base_dir = None
        ds.config = config
        ds.state = state
        ds.debug = False
        if config.get('use_binarized_labels'):
            ds.label_tags = ("background", "foreground")
        ds.data_split = None
        ds.cases = dict(cases)
        return ds

    def _load(self):
        raise NotImplementedError(
            "building a dataset from NIfTI files is not ported yet: use "
            "BaseDataset.from_cases or the JAX package's dataset cache")

    # -- id bookkeeping ----------------------------------------------------
    def get_3d_ids(self):
        return sorted(self.cases.keys())

    def switch_3d_identifiers(self, identifiers):
        if isinstance(identifiers, (np.ndarray,)):
            identifiers = identifiers.tolist()
        if not isinstance(identifiers, (list, tuple)):
            identifiers = [identifiers]
        ids = self.get_3d_ids()
        if all(isinstance(i, (int, np.integer)) for i in identifiers):
            return [ids[i] for i in identifiers]
        return [ids.index(i) if i in ids else None for i in identifiers]

    def __len__(self):
        return len(self.cases)

    # -- batch construction ------------------------------------------------
    def get_case(self, case_id):
        return self.cases[case_id]

    def make_batch(self, case_ids):
        """Collate cases into a batch dict of stacked numpy arrays (B, ...)."""
        cases = [self.cases[c] for c in case_ids]
        return {
            'label': np.stack([c['label'] for c in cases]),
            'image': np.stack([c['image'] for c in cases]),
            'nii_affine': np.stack([c['nii_affine'] for c in cases]),
            # (V, B, 4, 4)
            'view_affines': np.stack([c['input_view_affines'] for c in cases], axis=1),
        }

    def iterate_train_macrobatches(self, idxs, batch_size, accum_steps, rng):
        """Shuffled macrobatches with leading (accum, B, ...) axes (view affines
        (accum, V, B, 4, 4)); drops the last incomplete macrobatch."""
        ids = self.switch_3d_identifiers(list(idxs))
        order = rng.permutation(len(ids))
        macro = batch_size * accum_steps
        for start in range(0, len(ids) - macro + 1, macro):
            sel = [ids[i] for i in order[start:start + macro]]
            batch = self.make_batch(sel)
            yield sel, {
                k: v.reshape((accum_steps, batch_size) + v.shape[1:])
                if k != 'view_affines' else
                v.reshape((v.shape[0], accum_steps, batch_size) + v.shape[2:])
                .transpose(1, 0, 2, 3, 4)
                for k, v in batch.items()
            }

    def iterate_eval_batches(self, idxs, batch_size):
        ids = self.switch_3d_identifiers(list(idxs)) if idxs is not None \
            else self.get_3d_ids()
        for start in range(0, len(ids), batch_size):
            sel = ids[start:start + batch_size]
            yield sel, self.make_batch(sel)
