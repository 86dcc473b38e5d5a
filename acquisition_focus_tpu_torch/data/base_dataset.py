"""Dataset layer (torch port of ``acquisition_focus_tpu/data/base_dataset.py``):
NIfTI loading, the per-case geometric precompute, and batch iteration.

Everything constant per case is computed once at build (``_load``): the hires
resample, clinical view affines, centroid reorientation, the prescan, the
centroid-reoriented training volume and the per-view input grid affines. The
volumes are read on the host; every resample and moment reduction then runs on the
dataset's device (the card unless the caller passes ``device='cpu'``), through the
plain ``nifti_grid_sample`` (nearest for labels, trilinear with the min-shift for
images), as the JAX package's build does. Cases leave the build as numpy arrays:
'label' (D, H, W) int, 'image' (D, H, W) float, 'nii_affine' (4, 4) and
'input_view_affines' (V, 4, 4), the layout :meth:`BaseDataset.make_batch` collates.

Under ``clinical_view_affine_type='from-segmented'`` the frozen segmenter
(``segment_fn``, wired by ``set_segment_fn``) segments the prescan image; that
segmentation gives the prescan view planes, its hires interpolation the centroid
base, and both the reoriented volumes and the input view affines; a prescan whose
Dice or HD95 against the GT is worse than ``min_prescan_dice`` /
``max_prescan_hd95_mm`` fails the build.

Split layout, id parsing and fold construction follow the reference's
``metadata/data_split.json`` format.
"""

import json
from pathlib import Path

import numpy as np
import torch

from acquisition_focus_tpu_torch.data.nifti_io import load_nifti
from acquisition_focus_tpu_torch.geometry.centroids import register_centroids
from acquisition_focus_tpu_torch.geometry.clinical_views import (
    get_clinical_cardiac_view_affines)
from acquisition_focus_tpu_torch.ops.resample import nifti_grid_sample
from acquisition_focus_tpu_torch.ops.rotations import random_affine_from_jax_key
from acquisition_focus_tpu_torch.utils import jax_prng

_CLASS_DICT = {tag: idx for idx, tag in enumerate(
    ("background", "MYO", "LV", "RV", "LA", "RA"))}


def _prescan_quality(seg, gt, nii_affine, num_classes):
    """Dice / HD95 of the (hires-interpolated) segmented prescan against the hires
    GT: the build-time quality gate of from-segmented runs. HD95 in mm via the
    voxel-diagonal norm of the comparison grid's affine. ``seg``, ``gt``: arrays or
    tensors; the surface distances run on ``seg``'s device through the runner's
    device EDT, their roots and percentiles in float64 (the JAX package's scipy
    numbers)."""
    from acquisition_focus_tpu_torch.engine.metrics import hausdorff_per_class_device
    zooms = np.sqrt((np.asarray(nii_affine, np.float32)[:3, :3] ** 2).sum(0))
    seg = torch.as_tensor(seg)
    gt = torch.as_tensor(gt, device=seg.device)
    hd95 = hausdorff_per_class_device(seg[None].long(), gt[None].long(), num_classes,
                                      torch.float64)[0, :, 1].cpu().numpy()
    hd95 = hd95 * float(np.linalg.norm(zooms))
    seg, gt = seg.cpu().numpy(), gt.cpu().numpy()
    dice = np.full(num_classes, np.nan)
    for c in range(1, num_classes):
        p, t = seg == c, gt == c
        denom = p.sum() + t.sum()
        if denom > 0:
            dice[c] = 2.0 * np.logical_and(p, t).sum() / denom
    return {
        'dice': dice, 'hd95': hd95,
        'dice_mean': float(np.nanmean(dice[1:])),
        'hd95_mean': (float(np.nanmean(hd95[1:]))
                      if np.any(~np.isnan(hd95[1:])) else float('nan')),
    }


class BaseDataset:
    label_tags = ("background", "MYO", "LV", "RV", "LA", "RA")

    def __init__(self, data_base_dir, config, state='train', segment_fn=None,
                 debug=False, *, device=None):
        """``device``: where the build's resamples and reductions run (``None``:
        the card; resolved by ``engine.train.resolve_device`` when the build
        starts, so a dataset filled from the cache needs no card)."""
        self.data_base_dir = Path(data_base_dir)
        self.config = config
        self.state = state
        self.debug = debug
        self.segment_fn = segment_fn
        self.device = device
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
        ds.segment_fn = None
        ds.device = None
        if config.get('use_binarized_labels'):
            ds.label_tags = ("background", "foreground")
        ds.data_split = None
        ds.cases = dict(cases)
        return ds

    # -- subclass hooks ----------------------------------------------------
    @staticmethod
    def get_file_id(file_path):
        raise NotImplementedError

    def extract_3d_id(self, file_id):
        return file_id

    def set_segment_fn(self, fold_idx):
        """Frozen-segmenter hook for from-segmented modes; wired by subclasses when
        a segmenter checkpoint is configured."""
        self.segment_fn = None

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

    # -- load + precompute -------------------------------------------------
    def _files_for_state(self):
        if self.state == 'train':
            files = self.data_split['train_files']
        elif self.state == 'test':
            files = self.data_split['test_files']
        else:
            raise ValueError(self.state)
        if self.debug:
            files = files[:8]
        return files

    def _reference_heart_label(self, shape):
        """Canonical heart for centroid registration: the NIfTI at
        ``config.centroid_ref_path``, else the deterministic canonical phantom."""
        ref_path = self.config.get('centroid_ref_path')
        if ref_path:
            lbl, _ = load_nifti(ref_path)
            return lbl.astype(np.int32)
        from acquisition_focus_tpu_torch.data.synthetic import make_heart_phantom
        lbl, _, _ = make_heart_phantom(shape=tuple(shape), seed=42, tilt=0.0)
        return lbl

    def _load(self):
        from acquisition_focus_tpu_torch.engine.train import resolve_device
        cfg = self.config
        from_segmented = cfg.get('clinical_view_affine_type') == 'from-segmented'
        if from_segmented and self.segment_fn is None:
            raise RuntimeError(
                "clinical_view_affine_type='from-segmented' needs a segmenter: configure "
                "segment_model_path (set_segment_fn was not wired)")
        dev = resolve_device(self.device)
        hires_mm = torch.tensor(cfg['hires_fov_mm'], dtype=torch.float32, device=dev)
        hires_vox = tuple(cfg['hires_fov_vox'])
        prescan_mm = torch.tensor(cfg['prescan_fov_mm'], dtype=torch.float32, device=dev)
        prescan_vox = tuple(cfg['prescan_fov_vox'])
        num_sa = cfg.get('num_sa_slices', 15)

        def aff32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)[None]

        def resample(vol, nii, mm, vox, is_label, pre=None):
            out, _, out_nii = nifti_grid_sample(
                vol[None, None], aff32(nii), mm, vox, is_label=is_label,
                pre_grid_sample_affine=None if pre is None else aff32(pre))
            return out[0, 0], out_nii[0].cpu().numpy().astype(np.float64)

        img_paths, lbl_paths = {}, {}
        for f in self._files_for_state():
            fid, is_label = self.get_file_id(f)
            (lbl_paths if is_label else img_paths)[fid] = self.data_base_dir / f
        pair_ids = sorted(set(img_paths) & set(lbl_paths))

        ref_heart = None
        for fid in pair_ids:
            case = {}
            img, img_aff = load_nifti(img_paths[fid], dtype=np.float32)
            lbl, lbl_aff = load_nifti(lbl_paths[fid])
            img = torch.as_tensor(np.ascontiguousarray(img), device=dev)
            lbl = torch.as_tensor(np.ascontiguousarray(lbl.astype(np.int32)), device=dev)

            # both to the hires FOV
            hires_lbl, hires_nii = resample(lbl, lbl_aff, hires_mm, hires_vox, True)
            hires_img, _ = resample(img, img_aff, hires_mm, hires_vox, False)
            hires_img = (hires_img - hires_img.mean()) / torch.clamp(
                hires_img.std(correction=0), min=1e-8)
            case_label = (hires_lbl > 0).int() if cfg.get('use_binarized_labels') \
                else hires_lbl

            # clinical view affines from GT
            view_affines = get_clinical_cardiac_view_affines(
                hires_lbl, hires_nii, _CLASS_DICT, num_sa_slices=num_sa,
                return_unrolled=True)

            # canonical orientation via centroid registration
            if ref_heart is None:
                ref_heart = torch.as_tensor(self._reference_heart_label(hires_vox),
                                            device=dev)
            view_affines['centroids'] = np.asarray(
                register_centroids(ref_heart, hires_lbl, dof=6, seed=cfg.get('seed', 0)),
                np.float64)

            # prescan
            prescan_lbl, case['prescan_nii_affine'] = resample(
                hires_lbl, hires_nii, prescan_mm, prescan_vox, True)
            case['prescan_gt'] = prescan_lbl.cpu().numpy().astype(np.int32)
            if from_segmented:
                case['prescan_label'], prescan_views, case['prescan_quality'] = \
                    self._segmented_prescan(fid, hires_img, hires_lbl, hires_nii,
                                            case['prescan_nii_affine'], ref_heart,
                                            resample)
            else:
                case['prescan_label'] = case['prescan_gt']
                prescan_views = get_clinical_cardiac_view_affines(
                    prescan_lbl, case['prescan_nii_affine'], _CLASS_DICT,
                    num_sa_slices=num_sa, return_unrolled=True)
                prescan_views['centroids'] = view_affines['centroids']
            case['prescan_view_affines'] = prescan_views
            case['gt_view_affines'] = view_affines
            case['nifti_affine'] = hires_nii

            # the centroid-reoriented training volume and the per-view input grid
            # affines: the chosen source (GT or segmented prescan) gives both the
            # canonical base and the view planes
            chosen_views = prescan_views if from_segmented else view_affines
            base = chosen_views['centroids']
            r_lbl, r_nii = resample(case_label, hires_nii, hires_mm, hires_vox, True, base)
            r_img, _ = resample(hires_img, hires_nii, hires_mm, hires_vox, False, base)
            case['label'] = r_lbl.cpu().numpy().astype(np.int32)
            case['image'] = r_img.cpu().numpy().astype(np.float32)
            case['nii_affine'] = r_nii.astype(np.float32)
            case['input_view_affines'] = self._input_view_affines(chosen_views)

            self.cases[self.extract_3d_id(fid)] = case

    def _segmented_prescan(self, fid, hires_img, hires_lbl, hires_nii, prescan_nii,
                           ref_heart, resample):
        """The from-segmented prescan of one case: the prescan image resampled from
        the hires image and segmented by ``segment_fn``; its view planes; the
        centroid base registered on the segmentation interpolated back to the hires
        grid (which keeps registration and volume in one normalized grid space);
        and its Dice / HD95 against the hires GT, printed and gated. Returns
        (segmentation (numpy int32), view affine dict, quality dict)."""
        cfg = self.config
        hires_mm = torch.tensor(cfg['hires_fov_mm'], dtype=torch.float32,
                                device=hires_img.device)
        prescan_mm = torch.tensor(cfg['prescan_fov_mm'], dtype=torch.float32,
                                  device=hires_img.device)
        prescan_img, _ = resample(hires_img, hires_nii, prescan_mm,
                                  tuple(cfg['prescan_fov_vox']), False)
        seg = torch.as_tensor(self.segment_fn(prescan_img, prescan_nii),
                              device=hires_img.device).int()
        views = get_clinical_cardiac_view_affines(
            seg, prescan_nii, _CLASS_DICT, num_sa_slices=cfg.get('num_sa_slices', 15),
            return_unrolled=True)
        seg_hires, _ = resample(seg, prescan_nii, hires_mm, tuple(cfg['hires_fov_vox']),
                                True)
        views['centroids'] = np.asarray(
            register_centroids(ref_heart, seg_hires, dof=6, seed=cfg.get('seed', 0)),
            np.float64)
        q = _prescan_quality(seg_hires, hires_lbl, hires_nii, len(self.label_tags))
        print(f"  {fid} prescan dice={q['dice_mean']:.3f} hd95={q['hd95_mean']:.2f}mm")
        # a prescan segmentation this wrong would poison every view plane built
        # from it: fail the build instead
        min_dice = cfg.get('min_prescan_dice', 0.5)
        max_hd95 = cfg.get('max_prescan_hd95_mm', 12.0)
        if q['dice_mean'] < min_dice or (np.isfinite(q['hd95_mean'])
                                         and q['hd95_mean'] > max_hd95):
            raise RuntimeError(
                f"{fid}: segmented prescan quality below the build gate (dice "
                f"{q['dice_mean']:.3f} < {min_dice} or hd95 {q['hd95_mean']:.2f}mm > "
                f"{max_hd95}mm): train the segmenter longer (acquisition_focus_tpu_torch."
                "scripts.train_segmenter) or lower min_prescan_dice/max_prescan_hd95_mm "
                "explicitly")
        return seg.cpu().numpy().astype(np.int32), views, q

    def _input_view_affines(self, chosen_views):
        """(V, 4, 4) input grid affines for the configured base views:
        inv(centroid base) @ view affine; 'RND' views get a fixed strong random
        rotation, drawn from JAX's key (seed + 1000 + view index)."""
        cfg = self.config
        base_inv = np.linalg.inv(chosen_views['centroids'])
        affs = []
        for v_idx, name in enumerate(cfg['base_views']):
            if name == 'RND':
                aff = random_affine_from_jax_key(
                    jax_prng.key(cfg.get('seed', 0) + 1000 + v_idx),
                    rotation_strength=4.0, zoom_strength=0.0).numpy().astype(np.float64)
            else:
                aff = base_inv @ np.asarray(chosen_views[name], np.float64)
            affs.append(aff)
        return np.stack(affs).astype(np.float32)

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
