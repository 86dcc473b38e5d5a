"""Offline dataset preparation (torch port of ``acquisition_focus_tpu/data/
preprocess.py``):

  1. reorient to LPI axis order        (c3d -swapdim LPI)
  2. resample to isotropic 1 mm        (nearest for labels, trilinear for images)
  3. remap label values                (MMWHS {205,500,600,420,550} -> 1..5;
                                        MRXCAT {1,5,6,7,8} -> 1..5)
  4. crop around the label center to a fixed FOV (crop_around_label_center)
  5. emit the metadata/data_split.json fold layout consumed by the datasets

The resamples and the crop run in torch on ``device`` (the card unless the caller
passes ``device='cpu'``). The JAX package can route ``resample_iso`` through its
optional host library (``native/libafocus.so``) with the same geometry; the port
does not load it (``PARITY.md``).
"""

import json
from pathlib import Path

import numpy as np
import torch

from acquisition_focus_tpu_torch.data.nifti_io import load_nifti, save_nifti
from acquisition_focus_tpu_torch.ops.resample import (
    crop_around_label_center, nifti_grid_sample)

MMWHS_LABEL_MAP = {205: 1, 500: 2, 600: 3, 420: 4, 550: 5}
MRXCAT_LABEL_MAP = {1: 1, 5: 2, 6: 3, 7: 4, 8: 5}


def reorient_to_lpi(data, affine):
    """Permute/flip array axes so the affine's axis directions are (L, P, I):
    column i of the linear part points along negative world axis i."""
    affine = np.asarray(affine, np.float64)
    lin = affine[:3, :3]
    # world axis each voxel axis mostly moves along, and its sign
    order = np.argmax(np.abs(lin), axis=0)
    if len(set(order.tolist())) != 3:
        raise ValueError("degenerate affine orientation")
    perm = np.argsort(order)          # voxel axis order so axis i -> world axis i
    data = np.transpose(data, perm)
    new_lin = lin[:, perm]
    new_aff = np.eye(4)
    new_aff[:3, :3] = new_lin
    new_aff[:3, 3] = affine[:3, 3]
    for i in range(3):
        if new_aff[i, i] > 0:         # LPI: negative direction on every axis
            data = np.flip(data, axis=i)
            new_aff[:3, i] = -new_aff[:3, i]
            new_aff[:3, 3] += lin[:, perm][:, i] * (data.shape[i] - 1)
    return np.ascontiguousarray(data), new_aff


def resample_iso(data, affine, spacing_mm=1.0, is_label=False, *, device=None):
    """Resample to isotropic spacing, preserving physical extent, on ``device``.
    Returns (numpy volume, (4, 4) float64 affine)."""
    from acquisition_focus_tpu_torch.engine.train import resolve_device
    dev = resolve_device(device)
    shape = np.asarray(data.shape[:3], np.float64)
    zooms = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(0))
    fov_mm = zooms * shape
    out_vox = tuple(int(round(v)) for v in fov_mm / spacing_mm)

    vol = torch.as_tensor(np.asarray(data, np.float32), device=dev)[None, None]
    out, _, out_aff = nifti_grid_sample(
        vol, torch.as_tensor(np.asarray(affine), dtype=torch.float32, device=dev)[None],
        torch.as_tensor(fov_mm, dtype=torch.float32, device=dev), out_vox,
        is_label=is_label)
    out = out[0, 0].cpu().numpy()
    if is_label:
        out = out.astype(np.int32)
    return out, out_aff[0].cpu().numpy().astype(np.float64)


def remap_labels(label, mapping):
    out = np.zeros_like(label)
    for src, dst in mapping.items():
        out[label == src] = dst
    return out


def crop_case(label, image, affine, fov_mm=(192.0,) * 3, fov_vox=(128,) * 3, *,
              device=None):
    """Crop label and image around the label's mass center to ``fov_mm`` at
    ``fov_vox`` on ``device``; numpy in and out."""
    from acquisition_focus_tpu_torch.engine.train import resolve_device
    dev = resolve_device(device)
    lbl = torch.as_tensor(label.astype(np.int32), device=dev)[None, None]
    img = torch.as_tensor(image.astype(np.float32), device=dev)[None, None]
    c_lbl, c_img, c_aff = crop_around_label_center(
        lbl, torch.as_tensor(np.asarray(affine), dtype=torch.float32, device=dev)[None],
        torch.tensor(fov_mm, dtype=torch.float32, device=dev), fov_vox, image=img)
    return (c_lbl[0, 0].cpu().numpy().astype(np.int32),
            c_img[0, 0].cpu().numpy().astype(np.float32),
            c_aff[0].cpu().numpy().astype(np.float64))


def preprocess_case(image_path, label_path, out_dir, out_stem,
                    label_map=MMWHS_LABEL_MAP, iso_mm=1.0,
                    fov_mm=(192.0,) * 3, fov_vox=(128,) * 3, *, device=None):
    """Full per-case pipeline: load -> LPI -> 1mm iso -> remap -> crop -> save.

    Returns the written (image, label) file names.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    img, img_aff = load_nifti(image_path, dtype=np.float32)
    lbl, lbl_aff = load_nifti(label_path)
    lbl = lbl.astype(np.int64)

    img, img_aff = reorient_to_lpi(img, img_aff)
    lbl, lbl_aff = reorient_to_lpi(lbl, lbl_aff)
    img, img_aff = resample_iso(img, img_aff, iso_mm, is_label=False, device=device)
    lbl, lbl_aff = resample_iso(lbl, lbl_aff, iso_mm, is_label=True, device=device)
    lbl = remap_labels(lbl, label_map)

    c_lbl, c_img, c_aff = crop_case(lbl, img, lbl_aff, fov_mm, fov_vox, device=device)

    img_name = f"{out_stem}_image.nii.gz"
    lbl_name = f"{out_stem}_label.nii.gz"
    save_nifti(out_dir / img_name, c_img, c_aff)
    save_nifti(out_dir / lbl_name, c_lbl.astype(np.int16), c_aff)
    return img_name, lbl_name


def write_data_split(out_dir, train_files, test_files, num_folds=3,
                     nnunet_train_files=()):
    """Fold split json in the reference layout (metadata/data_split.json; indices
    address train_files entries)."""
    out_dir = Path(out_dir)
    (out_dir / 'metadata').mkdir(parents=True, exist_ok=True)
    n_cases = len(train_files) // 2
    folds = {}
    for k in range(num_folds):
        val = [i for i in range(n_cases) if i % num_folds == k]
        train = [i for i in range(n_cases) if i % num_folds != k]
        folds[f'fold_{k}'] = {
            'train_idxs': [2 * i for i in train],
            'val_idxs': [2 * i for i in val],
        }
    split = {
        'train_files': list(train_files),
        'test_files': list(test_files),
        'train_folds': folds,
        'nnunet_train_files': list(nnunet_train_files),
    }
    with open(out_dir / 'metadata/data_split.json', 'w') as f:
        json.dump(split, f, indent=2)
    return split
