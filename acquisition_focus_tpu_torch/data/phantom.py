"""Phantom cases for the port's dataset: ``make_heart_phantom`` labels at the hires
grid, with identity input view affines (as the JAX package's benchmark slices
them), in the case layout of ``data/base_dataset.py``."""

import numpy as np

from acquisition_focus_tpu.data.synthetic import make_heart_phantom


def phantom_cases(n_cases, shape, spacing, n_views, first_seed=0):
    """{case id: case} of ``n_cases`` phantoms drawn from consecutive seeds."""
    cases = {}
    for i in range(n_cases):
        label, image, affine = make_heart_phantom(shape=tuple(shape), seed=first_seed + i,
                                                  spacing=tuple(spacing))
        cases[f'phantom_{first_seed + i:04d}'] = {
            'label': label.astype(np.int32),
            'image': image.astype(np.float32),
            'nii_affine': affine.astype(np.float32),
            'input_view_affines': np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1)),
        }
    return cases
