"""Per-class centroid registration to a canonical reference heart (torch port of
``acquisition_focus_tpu/geometry/centroids.py``).

Aligns a case's label centroids to a fixed reference by fitting a 6/7-DOF affine
(R6 rotation + translation [+ zoom]) with AdamW. The class centers are reduced on
the labels' device; the fit itself (9 or 10 parameters, ``iters`` steps) runs on the
host CPU in float32: on the card each step is some twenty one-element kernels, about
10^4 launches per fit, each slower than the host's arithmetic.

The fit does not converge in its 500 steps: its result depends on the float
rounding of every step, so the port's matrix is not JAX's (``PARITY.md``). The
initial draws are JAX's (``utils/jax_prng.py``), and :func:`fit_centroid_affine`
takes the initial parameters, so a test can start both packages from the same ones.
"""

import numpy as np
import torch

from acquisition_focus_tpu_torch.geometry.moments import label_center
from acquisition_focus_tpu_torch.ops.rotations import rotation_from_r6
from acquisition_focus_tpu_torch.utils import jax_prng


def _class_centers_grid_space(label, classes):
    """Foreground centers per class, mapped to grid space: flip to (W, H, D) order and
    re-normalize by the (cubic) shape to [-1, 1]; homogeneous coordinate appended."""
    shp = np.asarray(label.shape, np.float64)
    centers = []
    for c in classes:
        center = label_center(label == c).cpu().numpy().astype(np.float64)
        centers.append(center[::-1] / shp[::-1] * 2.0 - 1.0)
    centers = np.stack(centers)
    return np.concatenate([centers, np.ones((centers.shape[0], 1))], axis=1)


def initial_params(seed, dof=6):
    """The fit's initial parameters, drawn as the JAX package draws them:
    ``k_zoom, k_rot, k_trans = split(key(seed), 3)``, standard normals."""
    k_zoom, k_rot, k_trans = jax_prng.split(jax_prng.key(seed), 3)
    params = {'rot': jax_prng.normal(k_rot, (6,)), 'trans': jax_prng.normal(k_trans, (3,))}
    if dof == 7:
        params['zoom'] = jax_prng.normal(k_zoom, (1,))
    return params


def _transform_matrix(p):
    # eye(4) * zoom also scales the homogeneous row, as the reference does
    zoom = p['zoom'][0] if 'zoom' in p else 1.0
    mat = (torch.eye(4) * zoom) @ rotation_from_r6(p['rot'][None])[0]
    trans = torch.cat([p['trans'], torch.zeros(1)])
    return mat + torch.cat([torch.zeros(4, 3), trans[:, None]], dim=1)


def fit_centroid_affine(fixed, moving, params, iters=500, lr=0.05):
    """Fit ``T`` minimizing mean((T @ moving.T).T - fixed)^2 from ``params``
    ({'rot': (6,), 'trans': (3,)[, 'zoom': (1,)]}) with ``iters`` AdamW steps
    (betas 0.9/0.999, eps 1e-8, weight decay 0.01, as ``optax.adamw``), on the CPU
    in float32. ``fixed``, ``moving``: (N, 4) homogeneous centers. Returns the
    fitted (4, 4) float32 tensor (not its inverse)."""
    fixed = torch.as_tensor(np.asarray(fixed), dtype=torch.float32)
    moving = torch.as_tensor(np.asarray(moving), dtype=torch.float32)
    p = {k: torch.tensor(np.asarray(v), dtype=torch.float32, requires_grad=True)
         for k, v in params.items()}
    opt = torch.optim.AdamW(list(p.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, foreach=False)
    for _ in range(iters):
        opt.zero_grad()
        pred = (_transform_matrix(p) @ moving.T).T
        torch.mean((pred - fixed) ** 2).backward()
        opt.step()
    with torch.no_grad():
        return _transform_matrix(p)


def register_centroids(fixed_label, moving_label, dof=6, iters=500, lr=0.05, seed=0):
    """Fit an affine mapping moving-label centroids onto fixed-label centroids.

    ``fixed_label``, ``moving_label``: cubic (D, D, D) integer label volumes
    (tensors on any device, or arrays). Returns the *inverse* fitted matrix, a
    (4, 4) float32 numpy array: the grid-space affine that reorients the moving
    volume into the canonical frame. The fitted affine lives in the moving
    volume's normalized grid space, so it is valid only for a grid spanning the
    same physical field of view.
    """
    if dof not in (6, 7):
        raise ValueError(f"dof must be 6 or 7, got {dof}")
    fixed_label = torch.as_tensor(fixed_label)
    moving_label = torch.as_tensor(moving_label)
    for lbl in (fixed_label, moving_label):
        if not lbl.shape[0] == lbl.shape[1] == lbl.shape[2]:
            raise ValueError(f"centroid registration needs cubic volumes, got "
                             f"{tuple(lbl.shape)}")

    common = sorted(set(torch.unique(fixed_label).tolist())
                    & set(torch.unique(moving_label).tolist()))
    common = [c for c in common if c != 0]
    fixed = _class_centers_grid_space(fixed_label, common)
    moving = _class_centers_grid_space(moving_label, common)
    mat = fit_centroid_affine(fixed.astype(np.float32), moving.astype(np.float32),
                              initial_params(seed, dof), iters, lr)
    return torch.linalg.inv(mat).numpy()


def centroid_reorient_grid_affine(moving_label, reference_label, dof=6):
    """Canonical-orientation affine for a case, given the reference heart label
    volume."""
    return register_centroids(reference_label, moving_label, dof=dof)
