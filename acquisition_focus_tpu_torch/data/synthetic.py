"""Synthetic cardiac phantom generation (the port's own copy of the JAX package's
``data/synthetic.py``; tests hold the phantoms and the written datasets equal).

The deployment environment carries no MMWHS/MRXCAT data, so tests and benchmarks run
on a geometric heart phantom with the same label vocabulary as MMWHS
(background, MYO, LV, RV, LA, RA — reference mmwhs_dataset.py:13-20): an LV ellipsoid
wrapped in a MYO shell, an RV crescent beside it, LA/RA pools at the base, with a
randomizable long-axis orientation so clinical-view derivation is non-trivial.
"""

import numpy as np

LABEL_TAGS = ("background", "MYO", "LV", "RV", "LA", "RA")


def _rotation_from_axis_angle(axis, angle):
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def make_heart_phantom(shape=(96, 96, 96), seed=0, spacing=(1.5, 1.5, 1.5),
                       tilt=0.35):
    """Build a labelled heart phantom.

    Returns:
      label: (D, H, W) int32 with classes 0..5 (LABEL_TAGS order).
      image: (D, H, W) float32 pseudo-MR intensities.
      affine: (4, 4) float64 NIfTI affine (diagonal spacing, centered origin).
    """
    rng = np.random.default_rng(seed)
    d, h, w = shape
    coords = np.stack(np.meshgrid(
        np.arange(d, dtype=np.float64), np.arange(h, dtype=np.float64),
        np.arange(w, dtype=np.float64), indexing='ij'), axis=-1)
    center = np.array([d, h, w]) / 2.0

    # long axis: mostly along D, tilted by a seeded random rotation
    axis = np.array([1.0, 0.0, 0.0])
    rot = _rotation_from_axis_angle(rng.normal(size=3), tilt * rng.uniform(0.5, 1.0))
    axis = rot @ axis
    # in-plane frame
    u = np.cross(axis, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)

    rel = coords - center
    ca = rel @ axis           # coordinate along long axis
    cu = rel @ u
    cv = rel @ v

    s = min(shape) / 96.0     # scale factors relative to a 96-box
    lv_len, lv_rad = 26 * s, 12 * s
    myo_th = 4 * s

    lv = (ca / lv_len) ** 2 + (cu / lv_rad) ** 2 + (cv / lv_rad) ** 2 <= 1.0
    myo_outer = ((ca / (lv_len + myo_th)) ** 2 + (cu / (lv_rad + myo_th)) ** 2
                 + (cv / (lv_rad + myo_th)) ** 2 <= 1.0)
    myo = myo_outer & ~lv & (ca < lv_len * 0.55)   # open at the base

    rv_center = (lv_rad + myo_th + 9 * s) * u - 2 * s * axis
    rv = (((ca - rv_center @ axis) / (20 * s)) ** 2
          + ((cu - rv_center @ u) / (9 * s)) ** 2
          + ((cv - rv_center @ v) / (11 * s)) ** 2 <= 1.0)

    la_center = (lv_len + 8 * s) * axis
    la = np.linalg.norm(rel - la_center, axis=-1) <= 9 * s
    ra_center = (lv_len + 7 * s) * axis + (lv_rad + 8 * s) * u
    ra = np.linalg.norm(rel - ra_center, axis=-1) <= 8 * s

    label = np.zeros(shape, np.int32)
    label[myo] = 1
    label[lv] = 2
    label[rv & (label == 0)] = 3
    label[la & (label == 0)] = 4
    label[ra & (label == 0)] = 5

    intensities = np.array([0.1, 0.9, 0.35, 0.4, 0.45, 0.5], np.float32)
    image = intensities[label]
    image += 0.05 * rng.standard_normal(shape).astype(np.float32)
    from scipy.ndimage import gaussian_filter
    image = gaussian_filter(image, sigma=1.0).astype(np.float32)

    affine = np.diag(list(spacing) + [1.0])
    affine[:3, 3] = -np.asarray(spacing) * center
    return label, image.astype(np.float32), affine


def write_phantom_dataset(base_dir, n_cases=6, shape=(96, 96, 96), seed=0,
                          file_pattern="mr_train_{idx:04d}_{kind}.nii.gz",
                          n_test=2):
    """Materialize a phantom dataset on disk in the reference's MMWHS prepared-files
    layout: image/label NIfTI pairs + metadata/data_split.json
    (reference base_dataset.py:46, main_acquisition_focus.py:152-158)."""
    import json
    from pathlib import Path
    from acquisition_focus_tpu_torch.data.nifti_io import save_nifti

    base_dir = Path(base_dir)
    (base_dir / "metadata").mkdir(parents=True, exist_ok=True)

    train_files, test_files = [], []
    for idx in range(n_cases):
        label, image, affine = make_heart_phantom(shape=shape, seed=seed + idx)
        img_name = file_pattern.format(idx=idx + 1, kind="image")
        lbl_name = file_pattern.format(idx=idx + 1, kind="label")
        # NIfTI files are (i, j, k) indexed; our arrays are (D, H, W) = (i, j, k)
        save_nifti(base_dir / img_name, image, affine)
        save_nifti(base_dir / lbl_name, label.astype(np.int16), affine)
        bucket = test_files if idx >= n_cases - n_test else train_files
        bucket += [img_name, lbl_name]

    n_train_cases = (len(train_files)) // 2
    folds = {}
    for k in range(3):
        val = [i for i in range(n_train_cases) if i % 3 == k]
        train = [i for i in range(n_train_cases) if i % 3 != k]
        # indices address train_files entries; use the label-file index per case
        folds[f"fold_{k}"] = {
            "train_idxs": [2 * i for i in train],
            "val_idxs": [2 * i for i in val],
        }

    split = {"train_files": train_files, "test_files": test_files,
             "train_folds": folds, "nnunet_train_files": []}
    with open(base_dir / "metadata/data_split.json", "w") as f:
        json.dump(split, f, indent=2)
    return split
