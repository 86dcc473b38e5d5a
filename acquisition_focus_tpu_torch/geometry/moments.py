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


def slice_min_principal_align_affines(slice_labels):
    """Grid-space affines that turn each slice so that the min-inertia axis of its
    non-background content becomes the in-plane principal direction.

    Args:
      slice_labels: (N, Sh, Sw, 1) integer labels (one-voxel-thick slices).
    Returns: (N, 4, 4) float32 grid affines on the labels' device.

    The masked moments run batched on the labels' device; the N 3x3 eigen-solves
    run on the host through :func:`principal_axes` (LAPACK's ``syevd``, whose
    eigenvector signs the JAX package's CPU ``eigh`` also gives; no sign rule is
    added). A flipped min axis turns the aligned slice by 180 degrees."""
    dev = slice_labels.device
    mask = (slice_labels != 0).float()
    shape = mask.shape[1:]
    grids = [g[None] for g in _coord_grids(shape, dev)]
    dims = (1, 2, 3)
    n = torch.clamp(mask.sum(dims), min=1.0)
    center = torch.stack([(g * mask).sum(dims) / n for g in grids], dim=-1)   # (N, 3)
    centered = [g - center[:, i, None, None, None] for i, g in enumerate(grids)]
    m2 = torch.stack([torch.stack([(a * b * mask).sum(dims) for b in centered], dim=-1)
                      for a in centered], dim=-2)                             # (N, 3, 3)
    eye = torch.eye(3, device=dev)
    inertia = m2.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None] * eye - m2
    center = center.clone()
    center[:, -1] = 0.5

    min_axes = np.stack([principal_axes(i)[0] for i in inertia.cpu().numpy()])
    main = torch.as_tensor(min_axes, device=dev)
    main = main / torch.linalg.norm(main, dim=-1, keepdim=True)
    second = torch.linalg.cross(main, eye[2].expand_as(main), dim=-1)
    two = second / torch.clamp(torch.linalg.norm(second, dim=-1, keepdim=True), min=1e-8)
    normal = torch.linalg.cross(main, two, dim=-1)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-8)
    two = torch.linalg.cross(normal, main, dim=-1)
    rows = torch.stack([two, main, normal], dim=1)        # the pixel frame's rows
    out = torch.eye(4, device=dev).repeat(len(rows), 1, 1)
    # pixel -> grid affine: axes reversed (x -> W), centre to [-1, 1]
    out[:, :3, :3] = rows.flip(1, 2).transpose(1, 2)
    size = torch.tensor(shape, dtype=torch.float32, device=dev)
    out[:, :3, 3] = (2.0 * center / size - 1.0).flip(-1)
    return out
