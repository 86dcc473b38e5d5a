"""Clinical cardiac view plane derivation from segmentation label masses (torch port
of ``acquisition_focus_tpu/geometry/clinical_views.py``).

Runs once per case at dataset build: derives axial/sagittal/coronal, pseudo-2CH/4CH,
N short-axis, 4CH and 2CH view affines from the inertia structure of the heart
labels. The label's masks, their moments and the 128 x 128 x 1 slice cuts run in
torch on the label's device; the 3x3 eigen-solves (``moments.principal_axes``) and
the data-dependent binary extent search stay on the host in numpy float64, as in
the JAX package.
"""

import numpy as np
import torch

from acquisition_focus_tpu_torch.geometry.moments import (
    label_inertia_tensor, principal_axes)
from acquisition_focus_tpu_torch.ops.resample import nifti_grid_sample

_MIN_DIST = 1.73 / 2  # sqrt(3)/2 vox: a voxel's half-diagonal
_UNITS = {'mm3': 1.0, 'cm3': 1e-3, 'ml': 1e-3, 'l': 1e-6}


def _normalize(v):
    return v / np.linalg.norm(v)


def pix_affine_from_center_and_plane_vects(center, main_plane_vect, plane_vect_two,
                                           center_projected=None,
                                           return_normal=False):
    """Orthonormal slice frame from a center point and two in-plane directions.

    Rows of the linear part are (second in-plane vector, main in-plane vector,
    normal); translation is the center (optionally re-projected onto the plane
    through ``center_projected``).
    """
    main_plane_vect = _normalize(np.asarray(main_plane_vect, np.float64))
    plane_vect_two = _normalize(np.asarray(plane_vect_two, np.float64))
    normal = _normalize(np.cross(main_plane_vect, plane_vect_two))
    plane_vect_two = np.cross(normal, main_plane_vect)

    affine = np.eye(4)
    affine[:3, :3] = np.stack([plane_vect_two, main_plane_vect, normal])

    center = np.asarray(center, np.float64)
    if center_projected is not None:
        delta = np.asarray(center_projected, np.float64) - center
        affine[:3, 3] = center + (delta - (delta @ normal) * normal)
    else:
        affine[:3, 3] = center

    if return_normal:
        return affine, normal
    return affine


def grid_affine_from_pix_affine(pix_affine, shape_dhw):
    """Convert a voxel-space slice frame into the grid-space affine consumed by the
    resampler (axis-order reversal plus [-1, 1] re-normalization of the center)."""
    out = np.array(pix_affine, np.float64)
    out[:3, :3] = out[:3, :3][::-1, ::-1].T
    out[:3, 3] = (2.0 * out[:3, 3] / np.asarray(shape_dhw) - 1.0)[::-1]
    return out


def _min_dist_to_mask(idxs, point):
    return np.linalg.norm(idxs - point[None, :], axis=1).min()


def _extent_vect(idxs, center, direction, end):
    """Distance along ``direction`` from ``center`` to the edge of the voxel cloud,
    found by binary search on nearest-voxel distance; ``end`` starts at the volume
    diagonal."""
    start = 0.0
    while (end - start) > _MIN_DIST:
        mid = end - (end - start) / 2.0
        if _min_dist_to_mask(idxs, center + mid * direction) > _MIN_DIST:
            end = mid
        else:
            start += (end - start) / 2.0
    return (start + end) / 2.0 * direction


def min_max_extent_along_axis(mask, direction):
    """Extreme points of the foreground cloud along +/- direction (host numpy
    float64; ``mask`` a tensor on any device, or an array)."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    mask = np.asarray(mask)
    idxs = np.argwhere(mask != 0).astype(np.float64)
    center = idxs.mean(0)
    direction = np.asarray(direction, np.float64)
    diag = float(np.linalg.norm(np.asarray(mask.shape, np.float64)))
    p_pos = center + _extent_vect(idxs, center, direction, diag)
    p_neg = center + _extent_vect(idxs, center, -direction, diag)
    return p_pos, p_neg


def _masked(label, class_values):
    # Sparse-COO semantics of the reference: zero (background) voxels are never
    # stored, so class filters can never match them even when 0 is in the filter set.
    values = torch.tensor(sorted(class_values), dtype=label.dtype, device=label.device)
    return torch.isin(label, values) & (label != 0)


def _inertia(mask):
    center, inertia = label_inertia_tensor(mask)
    return (center.cpu().numpy().astype(np.float64),
            inertia.cpu().numpy().astype(np.float64))


def _principals(inertia):
    return tuple(np.asarray(v, np.float64) for v in principal_axes(inertia))


def _slice_inertia_in_volume_space(mask, volume_affine, pix_affine, label_shape):
    """Principal axes of the label content of a 300 mm, 128 x 128 x 1 slice cut
    along ``pix_affine``, re-projected into volume space."""
    dev = mask.device
    slicing_affine = grid_affine_from_pix_affine(pix_affine, label_shape)
    slc, _, _ = nifti_grid_sample(
        mask.float()[None, None],
        torch.as_tensor(volume_affine, dtype=torch.float32, device=dev)[None],
        torch.tensor([300.0, 300.0, 1.0], device=dev), (128, 128, 1), is_label=True,
        pre_grid_sample_affine=torch.as_tensor(slicing_affine, dtype=torch.float32,
                                               device=dev)[None])
    _, inertia = _inertia(slc[0, 0])
    mins, mids, maxs = _principals(inertia)
    inv_lin = np.linalg.inv(pix_affine)[:3, :3]
    return inv_lin @ mins, inv_lin @ mids, inv_lin @ maxs


def _angle_between(v1, v2):
    return float(np.arccos(np.clip(_normalize(v1) @ _normalize(v2), -1.0, 1.0)))


def get_clinical_cardiac_view_affines(label, volume_affine, class_dict,
                                      num_sa_slices=3, return_unrolled=False):
    """Derive all clinical view grid-affines from a labelled heart volume.

    Args:
      label: (D, H, W) integer label volume: a tensor (its device runs the masks,
        moments and slice cuts) or an array (taken to the CPU).
      volume_affine: (4, 4) NIfTI affine.
      class_dict: tag -> class index; must contain MYO, LV, RV, LA.
      num_sa_slices: odd number of short-axis slices from base to apex.
      return_unrolled: flatten 'ALL_SA' into 'SA-i' keys.

    Returns: dict of view name -> (4, 4) grid-space affine (numpy float64);
      empty dict when any required structure is missing.
    """
    label = torch.as_tensor(label)
    if label.ndim != 3:
        raise ValueError(f"label must be (D, H, W), got {tuple(label.shape)}")
    for tag in ('LV', 'RV', 'MYO', 'LA'):
        if tag not in class_dict:
            raise KeyError(tag)
    if num_sa_slices % 2 != 1:
        raise ValueError(f"num_sa_slices must be odd, got {num_sa_slices}")
    label_shape = list(label.shape)
    volume_affine = np.asarray(volume_affine, np.float64)

    myolv = _masked(label, (class_dict['MYO'], class_dict['LV']))
    myolvla = _masked(label, (class_dict['MYO'], class_dict['LV'], class_dict['LA']))
    myolvrv = _masked(label, (class_dict['MYO'], class_dict['LV'], class_dict['RV']))
    heart = _masked(label, tuple(class_dict.values()))
    if not all(bool(m.any()) for m in (myolv, myolvla, myolvrv, heart)):
        return {}

    # 0. axial / sagittal / coronal through the heart center
    heart_center, _ = _inertia(heart)
    sagittal = np.array([1.0, 0.0, 0.0])
    coronal = np.array([0.0, 1.0, 0.0])
    axial = np.array([0.0, 0.0, 1.0])

    pix_axial = pix_affine_from_center_and_plane_vects(heart_center, sagittal, coronal)
    pix_coronal = pix_affine_from_center_and_plane_vects(heart_center, axial, sagittal)
    pix_sagittal = pix_affine_from_center_and_plane_vects(heart_center, coronal, axial)

    # 1. LV+MYO centerline, flipped to point toward the heart base
    myolv_center, lv_inertia = _inertia(myolv)
    lv_min_principal = _principals(lv_inertia)[0]
    if _angle_between(lv_min_principal, sagittal) < np.pi / 2:
        lv_min_principal = -lv_min_principal

    # 2./3. pseudo-2CH and pseudo-4CH from centerline x axial
    pix_p2ch, ortho_p2ch = pix_affine_from_center_and_plane_vects(
        myolv_center, lv_min_principal, axial,
        center_projected=heart_center, return_normal=True)
    pix_p4ch, ortho_p4ch = pix_affine_from_center_and_plane_vects(
        myolv_center, lv_min_principal, ortho_p2ch,
        center_projected=heart_center, return_normal=True)

    # 4. short-axis stack from base to apex along the centerline extent
    p1, p2 = min_max_extent_along_axis(myolv, lv_min_principal)
    delta_p = p2 - p1
    pix_sa_affines = [
        pix_affine_from_center_and_plane_vects(
            p1 + delta_p * i / (num_sa_slices - 1), ortho_p2ch, ortho_p4ch,
            center_projected=heart_center)
        for i in range(num_sa_slices)]

    # 5. true 4CH: principal directions measured inside the center-SA and p2CH cuts
    pix_center_sa = pix_affine_from_center_and_plane_vects(
        p1 + 0.5 * delta_p, ortho_p2ch, ortho_p4ch, center_projected=heart_center)
    sa_min, sa_mid, _ = _slice_inertia_in_volume_space(
        myolvrv, volume_affine, pix_center_sa, label_shape)
    p2ch_min = _slice_inertia_in_volume_space(
        myolvla, volume_affine, pix_p2ch, label_shape)[0]
    pix_4ch = pix_affine_from_center_and_plane_vects(
        myolv_center, sa_min, p2ch_min, center_projected=heart_center)

    # 6. true 2CH from the 4CH cut's in-plane principal
    myolvla_center, _ = _inertia(myolvla)
    ch4_min = _slice_inertia_in_volume_space(
        myolvla, volume_affine, pix_4ch, label_shape)[0]
    pix_2ch = pix_affine_from_center_and_plane_vects(
        myolvla_center, sa_mid, ch4_min, center_projected=heart_center)

    views = {
        'axial': grid_affine_from_pix_affine(pix_axial, label_shape),
        'sagittal': grid_affine_from_pix_affine(pix_sagittal, label_shape),
        'coronal': grid_affine_from_pix_affine(pix_coronal, label_shape),
        'p2CH': grid_affine_from_pix_affine(pix_p2ch, label_shape),
        'p4CH': grid_affine_from_pix_affine(pix_p4ch, label_shape),
        'ALL_SA': [grid_affine_from_pix_affine(a, label_shape) for a in pix_sa_affines],
        '4CH': grid_affine_from_pix_affine(pix_4ch, label_shape),
        '2CH': grid_affine_from_pix_affine(pix_2ch, label_shape),
    }

    if return_unrolled:
        unrolled = {}
        for name, aff in views.items():
            if name == 'ALL_SA':
                for i, a in enumerate(aff):
                    unrolled[f'SA-{i}'] = a
            else:
                unrolled[name] = aff
        return unrolled
    return views


def get_class_volumes(b_label, b_spacing, num_classes, unit='ml'):
    """Per-class volumes of a batch of dense label maps.

    Args:
      b_label: (B, D, H, W) integer labels. b_spacing: (B, 3) mm voxel spacing.
    Returns: (B, num_classes) float32 volumes in ``unit``.
    """
    if unit not in _UNITS:
        raise ValueError(unit)
    counts = torch.stack([(b_label == c).sum(dim=(1, 2, 3)) for c in range(num_classes)],
                         dim=1)
    voxel_mm3 = torch.as_tensor(b_spacing, dtype=torch.float32,
                                device=b_label.device).prod(dim=-1)
    return counts.float() * voxel_mm3[:, None] * _UNITS[unit]
