"""Segmentation metrics (torch port of ``acquisition_focus_tpu/engine/metrics.py``
and of ``_metrics_from_logits`` in its ``engine/train.py``).

Dice and IoU are plain tensor reductions; the surface metrics (HD/HD95) exist in
two implementations with one semantics, as in the JAX package:

* a host path in numpy/scipy with scipy's exact EDT (:func:`hausdorff_per_class`,
  the one for CPU tensors), and
* a device path (:func:`hausdorff_per_class_device`) computing the exact squared
  Euclidean distance transform as three separable min-plus passes,
  ``out[x] = min_j (g[j] + (x - j)^2)`` along each axis. XLA fuses the (..., n, n)
  operand of a pass into its min-reduce; eager torch would materialize it (1 GiB
  per mask at 128^3), so each pass runs over chunks of rows.

Semantics follow monai's ``compute_dice`` / ``compute_iou`` /
``compute_hausdorff_distance``: per-batch per-class scores, NaN where the ground
truth class is empty. The numpy functions are ported rather than imported: the
JAX module imports jax at its top.
"""

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import binary_erosion, distance_transform_edt


def dice_per_class(pred_onehot, target_onehot):
    """(B, C) dice; NaN where the target class is empty (monai ignore_empty)."""
    dims = tuple(range(2, pred_onehot.ndim))
    p = pred_onehot.float()
    t = target_onehot.float()
    inter = (p * t).sum(dims)
    denom = p.sum(dims) + t.sum(dims)
    dice = 2.0 * inter / torch.clamp(denom, min=1e-8)
    return torch.where(t.sum(dims) > 0, dice, torch.full_like(dice, float('nan')))


def metrics_from_logits(logits, target_onehot, num_eval):
    """Channel argmax (first maximum on ties) -> (pred (B, ...) int64,
    dice (B, num_eval))."""
    pred = torch.argmax(logits, dim=1)
    pred_oh = F.one_hot(pred, num_eval).movedim(-1, 1).float()
    return pred, dice_per_class(pred_oh, target_onehot)


def iou_per_class_labels(pred_labels, target_labels, num_classes):
    """(B, C) IoU from dense int label maps (B, ...); NaN where the target class
    is empty."""
    dims = tuple(range(1, pred_labels.ndim))
    cols = []
    for c in range(num_classes):
        p = pred_labels == c
        t = target_labels == c
        inter = (p & t).sum(dims).float()
        union = (p | t).sum(dims).float()
        iou = inter / torch.clamp(union, min=1e-8)
        cols.append(torch.where(t.sum(dims) > 0, iou, torch.full_like(iou, float('nan'))))
    return torch.stack(cols, dim=1)


# ---------------------------------------------------------------- host HD (scipy)

def _surface(mask):
    if not mask.any():
        return None
    eroded = binary_erosion(mask, iterations=1, border_value=0)
    return mask & ~eroded


def hausdorff_distance(pred_mask, target_mask, percentile=None):
    """Symmetric (percentile-)Hausdorff distance between two binary masks, in
    voxels: the max of the two directed distances, each the max (or percentile)
    of surface-to-surface distances. NaN when either mask is empty."""
    pred_mask = np.asarray(pred_mask, bool)
    target_mask = np.asarray(target_mask, bool)
    sp, st = _surface(pred_mask), _surface(target_mask)
    if sp is None or st is None:
        return float('nan')
    d_pt = distance_transform_edt(~st)[sp]
    d_tp = distance_transform_edt(~sp)[st]
    if percentile is None:
        return float(max(d_pt.max(), d_tp.max()))
    return float(max(np.percentile(d_pt, percentile), np.percentile(d_tp, percentile)))


def hausdorff_per_class(pred_labels, target_labels, num_classes, percentile=None):
    """(B, C) HD (or HD95) in voxels over dense label maps (numpy or CPU tensors);
    class 0 is 0, the reference's zero-padded background column."""
    pred_labels = np.asarray(pred_labels)
    target_labels = np.asarray(target_labels)
    out = np.zeros((pred_labels.shape[0], num_classes), np.float64)
    for b in range(pred_labels.shape[0]):
        for c in range(1, num_classes):
            out[b, c] = hausdorff_distance(pred_labels[b] == c, target_labels[b] == c,
                                           percentile)
    return out


# ---------------------------------------------------------------- device HD (torch)

_EDT_INF = 4.0e9  # > 3 * 65535^2: farther than any voxel in a representable volume

# elements of one chunk's (rows, n, n) min-plus operand: 2^26 floats = 256 MiB
_MINPLUS_CHUNK = 1 << 26


def _erode6(mask):
    """scipy ``binary_erosion`` with the default cross structure and
    border_value=0: a voxel survives iff it and its 6 face neighbours are set."""
    out = mask.clone()
    for axis in range(mask.ndim):
        n = mask.shape[axis]
        edge = torch.zeros_like(mask.narrow(axis, 0, 1))
        out &= torch.cat([edge, mask.narrow(axis, 0, n - 1)], dim=axis)
        out &= torch.cat([mask.narrow(axis, 1, n - 1), edge], dim=axis)
    return out


def _minplus_1d(g, axis):
    """One separable pass of the exact squared EDT along ``axis``:
    out[x] = min_j (g[j] + (x - j)^2), over chunks of rows so that the
    (rows, n, n) operand stays within ``_MINPLUS_CHUNK`` elements."""
    n = g.shape[axis]
    moved = g.movedim(axis, -1)
    rows = moved.reshape(-1, n)
    i = torch.arange(n, dtype=torch.float32, device=g.device)
    d2 = (i[:, None] - i[None, :]) ** 2
    out = torch.empty_like(rows)
    step = max(1, _MINPLUS_CHUNK // (n * n))
    for r in range(0, rows.shape[0], step):
        out[r:r + step] = (rows[r:r + step, None, :] + d2).amin(dim=-1)
    return out.reshape(moved.shape).movedim(-1, axis)


def edt_squared_device(mask):
    """Exact squared Euclidean distance from every voxel to the nearest True voxel
    of ``mask`` (== scipy ``distance_transform_edt(~mask)**2``). All-False masks
    give _EDT_INF everywhere."""
    g = torch.where(mask, 0.0, _EDT_INF).float()
    for axis in range(mask.ndim):
        g = _minplus_1d(g, axis)
    return g


@torch.no_grad()
def hausdorff_per_class_device(pred_labels, target_labels, num_classes,
                               dtype=torch.float32):
    """(B, C, 2) [HD, HD95] in voxels over dense label maps (B, D, H, W), on their
    device, with the host path's semantics: class 0 is 0, NaN when either mask is
    empty, percentiles with linear interpolation (numpy's default). The
    percentile runs over the surface voxels' distances only (``torch.quantile``
    of the selected values; ``jnp.nanpercentile`` over the NaN-masked volume
    gives the same number). The squared distances are exact integers; their
    square roots and percentiles are taken in ``dtype`` (float64: the host path's
    numbers)."""
    B = pred_labels.shape[0]
    out = torch.zeros((B, num_classes, 2), dtype=dtype, device=pred_labels.device)
    for b in range(B):
        for c in range(1, num_classes):
            pm, tm = pred_labels[b] == c, target_labels[b] == c
            if not (pm.any() and tm.any()):
                out[b, c] = float('nan')
                continue
            sp = pm & ~_erode6(pm)
            st = tm & ~_erode6(tm)
            d_pt = edt_squared_device(st)[sp].to(dtype).sqrt()
            d_tp = edt_squared_device(sp)[st].to(dtype).sqrt()
            out[b, c, 0] = torch.maximum(d_pt.max(), d_tp.max())
            out[b, c, 1] = torch.maximum(torch.quantile(d_pt, 0.95),
                                         torch.quantile(d_tp, 0.95))
    return out


# ---------------------------------------------------------------- score bookkeeping

def accumulate_label_scores(store, metric_name, scores, label_tags, exclude_bg=True):
    """Append per-sample scores (B, C) into {metric: {tag: [values...]}}."""
    scores = np.asarray(scores)
    for tag_idx, tag in enumerate(label_tags):
        if exclude_bg and tag_idx == 0:
            continue
        vals = store.setdefault(metric_name, {}).setdefault(tag, [])
        vals.extend(float(v) for v in scores[:, tag_idx])
    return store


def reduce_label_scores(store):
    """-> (nanmean_per_label, std_per_label, nanmean_overall, std_overall)."""
    nanmean_per_label, std_per_label = {}, {}
    nanmean_oa, std_oa = {}, {}
    for m_name, m_dict in store.items():
        nanmean_per_label[m_name] = {t: float(np.nanmean(v)) for t, v in m_dict.items()}
        std_per_label[m_name] = {t: float(np.std(v)) for t, v in m_dict.items()}
        all_vals = [x for v in m_dict.values() for x in v]
        nanmean_oa[m_name] = float(np.nanmean(all_vals)) if all_vals else float('nan')
        std_oa[m_name] = float(np.std(all_vals)) if all_vals else float('nan')
    return nanmean_per_label, std_per_label, nanmean_oa, std_oa
