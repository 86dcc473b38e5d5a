"""Dense-mask moment analysis of label volumes (torch port of
``acquisition_focus_tpu/geometry/moments.py``): masked float32 reductions on the
mask's device, as the JAX package computes them with static shapes.

The 3x3 eigen-solve of :func:`principal_axes` runs on the host, in float32, through
LAPACK's divide-and-conquer ``syevd`` (``scipy.linalg.eigh(..., driver='evd')``), the
routine jaxlib's CPU ``eigh`` calls: an eigenvector's sign is LAPACK's choice, and
the view planes built from these axes are not sign-normalised, so a flipped axis
turns a view's in-plane frame by 180 degrees. ``torch.linalg.eigh`` picks other
signs (on the CPU for about one matrix in six, and cuSOLVER on the card again
others), so it is not used (``PARITY.md``).
"""

import numpy as np
import scipy.linalg
import torch


def _coord_grids(shape, device):
    return torch.meshgrid(*[torch.arange(n, dtype=torch.float32, device=device)
                            for n in shape], indexing='ij')


def label_center(mask):
    """Mass center (voxel coords, (3,)) of a boolean/float foreground mask (D, H, W)."""
    mask = mask.float()
    n = torch.clamp(mask.sum(), min=1.0)
    return torch.stack([(g * mask).sum() / n for g in _coord_grids(mask.shape, mask.device)])


def label_center_and_median(mask):
    """Mass center and per-axis median of foreground voxel coordinates (the median
    of ``count`` entries is element (count - 1) // 2, as ``torch.median``); for an
    empty mask both fall back to the volume center."""
    m = mask != 0
    count = int(m.sum())
    fallback = torch.tensor(mask.shape, dtype=torch.float32, device=mask.device) / 2.0
    if count == 0:
        return fallback, fallback.clone()
    center = label_center(m)
    medians = [torch.sort(g[m]).values[(count - 1) // 2]
               for g in _coord_grids(m.shape, m.device)]
    return center, torch.stack(medians)


def label_inertia_tensor(mask):
    """(center (3,), inertia (3, 3)) of the foreground voxel distribution, with unit
    mass per voxel: I = tr(M2) * eye - M2 where M2 is the centered second moment."""
    mask = (mask != 0).float()
    n = torch.clamp(mask.sum(), min=1.0)
    grids = _coord_grids(mask.shape, mask.device)
    center = torch.stack([(g * mask).sum() / n for g in grids])
    centered = [g - c for g, c in zip(grids, center)]
    m2 = torch.stack([torch.stack([(a * b * mask).sum() for b in centered])
                      for a in centered])
    inertia = torch.trace(m2) * torch.eye(3, device=mask.device) - m2
    return center, inertia


def principal_axes(inertia):
    """(min, mid, max) principal axes of a symmetric 3x3 inertia tensor, ordered by
    ascending eigenvalue, as float32 numpy vectors (signs as LAPACK's ``syevd``
    gives them, see the module docstring). ``inertia``: a tensor on any device, or
    an array."""
    if isinstance(inertia, torch.Tensor):
        inertia = inertia.detach().cpu().numpy()
    a = np.asarray(inertia, np.float32)
    a = (a + a.T) / np.float32(2.0)             # jnp.linalg.eigh symmetrizes its input
    _, vecs = scipy.linalg.eigh(a, lower=True, driver='evd')
    return vecs[:, 0], vecs[:, 1], vecs[:, 2]
