"""The frozen prescan segmenter (torch port of
``acquisition_focus_tpu/engine/segmenter.py``): the 2D U-Net
(``models/segmentation/unet2d.py``) loaded from a ``torch.save`` checkpoint or
the JAX package's orbax directory, and gaussian-weighted sliding-window inference with 2^2 flip test-time augmentation.

The JAX package runs one jitted host call per tile. Here every tile of every slice
of a volume goes through the network together, in batches of ``max_batch`` tiles
per flip: the network's norms are per sample, so a tile's logits do not depend on
what else is in its batch, and the blending is the same sums in the same order.

``make_segment_fn`` returns None when no checkpoint is configured or the configured
one does not exist (every 'from-gt' configuration). Train a checkpoint with
``python -m acquisition_focus_tpu_torch.scripts.train_segmenter``.
"""

import numpy as np
import torch

from acquisition_focus_tpu_torch.engine.checkpoint import checkpoint_exists, load_checkpoint
from acquisition_focus_tpu_torch.ops.resample import image_resize


def compute_sliding_steps(image_size, tile_size, step_fraction=0.5):
    """Evenly spread tile origins covering the image."""
    steps = []
    for img, tile in zip(image_size, tile_size):
        if img <= tile:
            steps.append([0])
            continue
        target_step = tile * step_fraction
        n = int(np.ceil((img - tile) / target_step)) + 1
        actual = (img - tile) / max(n - 1, 1)
        steps.append([int(round(actual * i)) for i in range(n)])
    return steps


def gaussian_importance_map(tile_size, sigma_scale=1.0 / 8):
    """Center-weighted tile importance, float32 numpy, peak 1, no zeros."""
    grids = np.meshgrid(*[np.arange(t, dtype=np.float64) for t in tile_size],
                        indexing='ij')
    g = np.ones(tile_size, np.float64)
    for grid, t in zip(grids, tile_size):
        sigma = t * sigma_scale
        g *= np.exp(-0.5 * ((grid - (t - 1) / 2.0) / sigma) ** 2)
    g /= g.max()
    g[g == 0] = g[g > 0].min()
    return g.astype(np.float32)


def flip_tta_logits(model, x, mirror_tta=True):
    """(N, C_in, h, w) -> (N, classes, h, w): the plain logits, or with
    ``mirror_tta`` the mean over the 2^2 in-plane flips, summed in the JAX
    package's order."""
    logits = model(x).float()
    if mirror_tta:
        for dims in ((2,), (3,), (2, 3)):
            logits = logits + torch.flip(model(torch.flip(x, dims)).float(), dims)
        logits = logits / 4.0
    return logits


@torch.no_grad()
def sliding_window_logits_2d(model, images, num_classes, tile_size, mirror_tta=True,
                             step_fraction=0.5, max_batch=64):
    """Tiled 2D inference with gaussian blending and flip TTA.

    Args:
      model: (B, C_in, th, tw) -> (B, num_classes, th, tw) logits.
      images: (N, C_in, H, W) float (already normalized), N slices of one size.
      tile_size: (th, tw), clamped to the image.
      max_batch: tiles per network call.
    Returns: (N, num_classes, H, W) float32 logits.
    """
    N, _, H, W = images.shape
    th, tw = min(tile_size[0], H), min(tile_size[1], W)
    steps_h, steps_w = compute_sliding_steps((H, W), (th, tw), step_fraction)
    origins = [(sh, sw) for sh in steps_h for sw in steps_w]
    tiles = torch.cat([images[:, :, sh:sh + th, sw:sw + tw] for sh, sw in origins])
    out = torch.cat([flip_tta_logits(model, tiles[i:i + max_batch], mirror_tta)
                     for i in range(0, tiles.shape[0], max_batch)])
    gauss = torch.as_tensor(gaussian_importance_map((th, tw)), device=images.device)
    out = (out * gauss).reshape(len(origins), N, num_classes, th, tw)

    acc = torch.zeros((N, num_classes, H, W), dtype=torch.float32, device=images.device)
    norm = torch.zeros((H, W), dtype=torch.float32, device=images.device)
    for (sh, sw), tile_out in zip(origins, out):
        acc[:, :, sh:sh + th, sw:sw + tw] += tile_out
        norm[sh:sh + th, sw:sw + tw] += gauss
    return acc / torch.clamp(norm, min=1e-8)


def _spacing_from(nii_affine_or_spacing):
    """(4,4)/(B,4,4) affine or length-3 spacing -> (3,) mm spacing, or None."""
    if nii_affine_or_spacing is None:
        return None
    if isinstance(nii_affine_or_spacing, torch.Tensor):
        nii_affine_or_spacing = nii_affine_or_spacing.detach().cpu().numpy()
    arr = np.asarray(nii_affine_or_spacing, np.float64)
    if arr.shape[-2:] == (4, 4):
        if arr.ndim == 3:
            arr = arr[0]
        return np.linalg.norm(arr[:3, :3], axis=0)
    return arr.reshape(-1)[:3]


def load_segmenter(model_path, num_classes, device):
    """The checkpoint's ``SegUnet2D`` in eval mode on ``device``, without
    gradients; its widths are read from the saved weights. None where no
    checkpoint is at ``model_path`` (a file, or an orbax directory of the JAX
    package, imported through ``engine/orbax_import.py``)."""
    from acquisition_focus_tpu_torch.models.segmentation.unet2d import SegUnet2D
    if not checkpoint_exists(model_path):
        return None
    state = load_checkpoint(model_path)
    params = state['params'] if 'params' in state else state
    features, s = [], 0
    while f'enc{s}a_conv.weight' in params:
        features.append(params[f'enc{s}a_conv.weight'].shape[0])
        s += 1
    model = SegUnet2D(num_classes, features)
    model.load_state_dict(params)
    model.eval().requires_grad_(False)
    return model.to(device)


def make_segment_fn(model_path, fold_idx, num_classes=6, extra_permute=False,
                    tile_size=(128, 128), mirror_tta=True,
                    train_spacing=(1.5, 1.5, 1.5), *, device=None):
    """The frozen segmenter closure: (D, H, W) volume -> (D, H, W) int32 labels on
    ``device`` (``None``: the card), segmented slice by slice along axis 0.

    The closure takes the volume's NIfTI affine (or spacing) and respaces the input
    to ``train_spacing`` first (``image_resize`` 'linear'), then brings the labels
    back to the input grid ('nearest'). ``extra_permute`` transposes each output
    slice (the MMWHS axis convention of external segmenters). Returns None without
    a checkpoint at ``model_path``."""
    if not model_path or not checkpoint_exists(model_path):
        return None
    from acquisition_focus_tpu_torch.engine.train import resolve_device
    device = resolve_device(device)
    model = load_segmenter(model_path, num_classes, device)
    train_spacing = None if train_spacing is None \
        else np.asarray(train_spacing, np.float64)

    @torch.no_grad()
    def segment_fn(volume, nii_affine_or_spacing=None):
        vol = torch.as_tensor(volume, device=device).float()
        in_shape = tuple(vol.shape)
        spacing = _spacing_from(nii_affine_or_spacing)
        respace = (spacing is not None and train_spacing is not None
                   and not np.allclose(spacing, train_spacing, rtol=0.05))
        if respace:
            net_shape = tuple(max(1, int(round(s * sp / tsp)))
                              for s, sp, tsp in zip(in_shape, spacing, train_spacing))
            vol = image_resize(vol, net_shape, 'linear')
        vol = (vol - vol.mean()) / torch.clamp(vol.std(correction=0), min=1e-8)
        logits = sliding_window_logits_2d(model, vol[:, None], num_classes, tile_size,
                                          mirror_tta)
        pred = logits.argmax(dim=1).int()
        if respace:
            pred = image_resize(pred, in_shape, 'nearest')
        if extra_permute:
            pred = pred.transpose(1, 2)
        return pred.contiguous()

    return segment_fn
