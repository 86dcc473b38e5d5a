"""The training step (torch port of ``acquisition_focus_tpu/engine/train.py``).

One ``train_step`` is one optimizer update over ``num_grad_accum_steps``
microbatches: per-view prescan resample (kernel K2) and localization nets, the
differentiable slicing of the soft label along view @ theta, the hybrid U-Net
(kernels K1 and K3), Dice+CE, the mean of the microbatch gradients, and both AdamW
updates. Stage-wise trainability follows the JAX package: frozen views' locnets
run without a backward graph, their gradients are masked, and their parameters
are not updated (so decoupled weight decay leaves them bit-unchanged).

``theta_pass`` snapshots every sample's thetas for the cached-theta cadence
(``theta_source='cached'``: the step takes them from the batch and runs no
localization net); ``eval_step`` is the forward-only step of validation and test.
From-segmented slicing, slice alignment to the principal axis and EPix2Vox are not
ported yet.
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from acquisition_focus_tpu_torch.engine.losses import binarize_onehot, dice_ce_loss
from acquisition_focus_tpu_torch.engine.metrics import metrics_from_logits
from acquisition_focus_tpu_torch.models.atm import (
    AffineTransformModule, apply_stacked_atms)
from acquisition_focus_tpu_torch.models.hybrid_unet import Conv3x3x3, HybridUnet
from acquisition_focus_tpu_torch.ops.affine import compose
from acquisition_focus_tpu_torch.ops.resample import (
    nifti_grid_sample, nifti_grid_sample_nodiff, resize_trilinear)
from acquisition_focus_tpu_torch.ops.rotations import random_affine_batch


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Static stage description; the same fields as the JAX package's StageSpec
    (its remat/save-name fields are kept for config compatibility; recompute is
    not ported, so ``make_models`` refuses any value but the default)."""
    n_views: int
    num_classes: int
    n_active_views: int
    view_optimization_mode: str          # opt-all | opt-current-fix-previous | opt-none
    use_affine_theta: bool
    use_binarized_labels: bool = False
    optimize_lv_only: bool = False
    lv_class: int = 2
    hires_fov_mm: Tuple[float, ...] = (192.0, 192.0, 192.0)
    hires_fov_vox: Tuple[int, ...] = (128, 128, 128)
    slice_fov_mm: Tuple[float, ...] = (192.0, 192.0, 1.5)
    slice_fov_vox: Tuple[int, ...] = (128, 128, 1)
    prescan_fov_mm: Tuple[float, ...] = (192.0, 192.0, 192.0)
    prescan_fov_vox: Tuple[int, ...] = (128, 128, 128)
    optim_method: str = 'R6-vector'
    offset_clip_value: float = 0.2
    zoom_clip_value: float = 0.0
    rotate_slice_to_min_principle: bool = False
    label_slice_type: str = 'from-gt'
    augment_input: bool = True
    augment_recon: bool = False
    augment_strength: float = 1.0
    num_grad_accum_steps: int = 2
    compute_dtype: str = 'bfloat16'
    model_type: str = 'hybrid-unet'
    atm_remat: bool = False
    unet_remat: bool = False
    use_pallas_conv3d: object = False
    decoder_save_names: Tuple[str, ...] = ('conv_out', 'conv_in0')
    base_features: Tuple[int, ...] = (16, 32, 64, 128, 256, 256)
    locnet_width: int = 32
    theta_source: str = 'locnet'

    @property
    def dtype(self):
        return torch.bfloat16 if self.compute_dtype == 'bfloat16' else torch.float32

    def view_train_mask(self):
        """(n_active_views,) bool: which views' thetas receive gradients."""
        mask = np.zeros(self.n_active_views, bool)
        if not self.use_affine_theta or self.theta_source == 'cached':
            return mask
        if self.view_optimization_mode == 'opt-all':
            mask[:] = True
        elif self.view_optimization_mode == 'opt-current-fix-previous':
            mask[-1] = True
        return mask


def _check_ported(spec):
    missing = [name for name, on in (
        (f"model_type={spec.model_type!r}", spec.model_type != 'hybrid-unet'),
        ("rotate_slice_to_min_principle", spec.rotate_slice_to_min_principle),
        ("atm_remat", spec.atm_remat),
        ("unet_remat", spec.unet_remat),
        (f"decoder_save_names={spec.decoder_save_names!r}",
         tuple(spec.decoder_save_names) != StageSpec.decoder_save_names),
    ) if on]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def make_models(spec: StageSpec, device=None):
    """(HybridUnet, nn.ModuleList of n_views AffineTransformModules)."""
    _check_ported(spec)
    unet = HybridUnet(spec.n_views, spec.num_classes, tuple(spec.base_features),
                      dtype=spec.dtype, use_pallas_conv=spec.use_pallas_conv3d)
    atms = nn.ModuleList([
        AffineTransformModule(spec.num_classes, spec.optim_method,
                              spec.prescan_fov_vox[0], spec.offset_clip_value,
                              spec.zoom_clip_value, spec.locnet_width, spec.dtype)
        for _ in range(spec.n_views)])
    return unet.to(device), atms.to(device)


@torch.no_grad()
def init_params(unet, atms, generator):
    """Initialize in place from flax's distributions: lecun-normal weights
    (truncated normal on [-2, 2] std, std = sqrt(1/fan_in) / 0.8796), zero biases,
    unit norm scales. Draws come from ``generator`` (CPU) in module order."""
    def lecun_normal(w, fan_in):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        t = torch.empty(w.shape)
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        w.copy_(t)

    for m in list(unet.modules()) + list(atms.modules()):
        if isinstance(m, nn.ConvTranspose3d):
            lecun_normal(m.weight, m.weight.shape[0] * m.weight[0, 0].numel())
        elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, Conv3x3x3)):
            lecun_normal(m.weight, m.weight[0].numel())
        elif isinstance(m, (nn.InstanceNorm2d, nn.InstanceNorm3d)):
            m.weight.fill_(1.0)
        else:
            continue
        m.bias.zero_()


def _fold(x):
    """(V, B, ...) -> (V*B, ...)"""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def compute_thetas(spec: StageSpec, atms, soft_label, nii_affine, view_affines):
    """Prescan resample (kernel K2, no gradient) + localization nets ->
    (A, B, 4, 4) learned corrections."""
    A = spec.n_active_views
    B, C = soft_label.shape[:2]
    prescan, _, _ = nifti_grid_sample_nodiff(
        soft_label.to(spec.dtype), nii_affine, spec.prescan_fov_mm,
        spec.prescan_fov_vox, pre_grid_sample_affine=_fold(view_affines).detach())
    prescan = prescan.reshape((A, B, C) + tuple(spec.prescan_fov_vox))
    return apply_stacked_atms(atms, prescan, spec.view_train_mask())


def extract_view_slices(spec: StageSpec, atms, soft_label, nii_affine, view_affines,
                        augment_generator=None, cached_thetas=None):
    """Per-view model-input slices along learned view planes.

    Args:
      soft_label: (B, C, D, H, W) float one-hot label volume.
      nii_affine: (B, 4, 4).
      view_affines: (A, B, 4, 4) input grid affines of the active views.
      augment_generator: optional CPU ``torch.Generator``: per-sample input
        orientation augmentation shared across views.
      cached_thetas: (A, B, 4, 4) thetas snapshotted by :func:`theta_pass`; under
        ``theta_source='cached'`` they replace the prescan and localization nets
        (the cache was taken from the unaugmented view orientation).

    Returns: (slices (A, B, C, Sh, Sw), grid_affines (A, B, 4, 4),
              out_nii_affines (A, B, 4, 4), thetas (A, B, 4, 4)).
    """
    A = spec.n_active_views
    B, C = soft_label.shape[:2]
    if augment_generator is not None:
        aug = random_affine_batch(
            augment_generator, B, rotation_strength=0.1 * spec.augment_strength,
            zoom_strength=0.2 * spec.augment_strength, offset_strength=0.0,
            device=soft_label.device)
        view_affines = compose(view_affines, aug[None])

    if spec.use_affine_theta and spec.theta_source == 'cached':
        thetas = cached_thetas.float().detach()
    elif spec.use_affine_theta:
        thetas = compute_thetas(spec, atms, soft_label, nii_affine, view_affines)
    else:
        thetas = torch.eye(4, device=soft_label.device).expand(A, B, 4, 4)

    pre = compose(view_affines, thetas)
    slices, grid_affines, out_nii = nifti_grid_sample(
        soft_label, nii_affine, spec.slice_fov_mm, spec.slice_fov_vox,
        pre_grid_sample_affine=_fold(pre))
    Sh, Sw, Sd = spec.slice_fov_vox
    slices = slices.reshape(A, B, C, Sh, Sw, Sd)[..., 0]
    Hh, Hw = spec.hires_fov_vox[:2]
    if (Sh, Sw) != (Hh, Hw):
        # upsample to the hires in-plane resolution
        up = resize_trilinear(_fold(slices)[..., None], (Hh, Hw, 1))[..., 0]
        slices = up.reshape(A, B, C, Hh, Hw)
    return slices, grid_affines.reshape(A, B, 4, 4), out_nii.reshape(A, B, 4, 4), thetas


def assemble_model_input(spec: StageSpec, slices, grid_affines, augment_generator=None):
    """Duplicate the last active view into the missing ones and stack the views on
    the channel axis: (B, V*C, S, S) input + (V, B, 4, 4) affines."""
    A, V = spec.n_active_views, spec.n_views
    idx = list(range(A)) + [A - 1] * (V - A)
    slices = slices[idx]
    grid_affines = grid_affines[idx]
    if augment_generator is not None:
        aug = random_affine_batch(
            augment_generator, slices.shape[1],
            rotation_strength=0.1 * spec.augment_strength,
            zoom_strength=0.2 * spec.augment_strength, offset_strength=0.0,
            device=slices.device)
        grid_affines = compose(grid_affines, aug[None])
    return torch.cat(list(slices), dim=1), grid_affines


def forward(spec: StageSpec, unet, atms, batch, augment_generator=None):
    """Volumes -> view slices -> reconstruction -> loss.

    ``batch``: 'label' (B, D, H, W) int, 'nii_affine' (B, 4, 4),
    'view_affines' (V, B, 4, 4), and under ``theta_source='cached'`` 'thetas'
    (A, B, 4, 4). Augmentation draws come from
    ``augment_generator`` (None: no augmentation)."""
    label = batch['label']
    nii_affine = batch['nii_affine']
    view_affines = batch['view_affines'][:spec.n_active_views]
    onehot = F.one_hot(label.long(), spec.num_classes).movedim(-1, 1).float()

    aug_in = augment_generator if spec.augment_input else None
    aug_re = augment_generator if spec.augment_recon else None
    slices, grid_affines, out_nii, thetas = extract_view_slices(
        spec, atms, onehot, nii_affine, view_affines, aug_in, batch.get('thetas'))
    b_input, grid_affines_full = assemble_model_input(spec, slices, grid_affines, aug_re)
    logits = unet(b_input, grid_affines_full)

    target, y_hat = onehot, logits
    if spec.use_binarized_labels:
        target, y_hat = binarize_onehot(target), binarize_onehot(y_hat)
    if spec.optimize_lv_only:
        sel = [0, spec.lv_class]
        loss = dice_ce_loss(y_hat[:, sel], target[:, sel])
    else:
        loss = dice_ce_loss(y_hat, target)
    aux = {'logits': y_hat, 'target_onehot': target, 'grid_affines': grid_affines_full,
           'out_nii_affines': out_nii, 'thetas': thetas, 'b_input': b_input}
    return loss, aux


def train_step(spec: StageSpec, unet, atms, recon_opt, trans_opt, batch,
               augment_generator=None):
    """One optimizer update over ``num_grad_accum_steps`` microbatches.

    ``recon_opt``/``trans_opt``: (optimizer, scheduler) pairs from
    ``engine.optimizers``. ``batch`` leaves have a leading (accum, ...) axis.
    Returns {'loss': mean microbatch loss, 'dice': (accum*B, classes)}."""
    accum = spec.num_grad_accum_steps
    num_eval = 2 if spec.use_binarized_labels else spec.num_classes
    for opt, _ in (recon_opt, trans_opt):
        opt.zero_grad(set_to_none=True)

    losses, dices = [], []
    for i in range(accum):
        micro = {k: v[i] for k, v in batch.items()}
        loss, aux = forward(spec, unet, atms, micro, augment_generator)
        (loss / accum).backward()
        with torch.no_grad():
            _, dice = metrics_from_logits(aux['logits'], aux['target_onehot'], num_eval)
        losses.append(loss.detach())
        dices.append(dice)
        del loss, aux

    # per-view trainability: frozen (and inactive) views get no gradient and so
    # no AdamW update — no weight decay either
    full_mask = np.zeros(spec.n_views, bool)
    full_mask[:spec.n_active_views] = spec.view_train_mask()
    for v in np.flatnonzero(~full_mask):
        for p in atms[v].parameters():
            p.grad = None

    for opt, sched in (recon_opt,) + ((trans_opt,) if full_mask.any() else ()):
        opt.step()
        sched.step()
    return {'loss': torch.stack(losses).mean(), 'dice': torch.cat(dices)}


@torch.no_grad()
def theta_pass(spec: StageSpec, atms, batch):
    """Snapshot every sample's learned view corrections: (A, B, 4, 4).

    Forward only, unaugmented, no gradient: the theta-refresh cadence fills its
    per-sample cache with it after each window of transform updates. ``spec``
    must compute thetas (``theta_source='locnet'``)."""
    onehot = F.one_hot(batch['label'].long(), spec.num_classes).movedim(-1, 1).float()
    view_affines = batch['view_affines'][:spec.n_active_views]
    return compute_thetas(spec, atms, onehot, batch['nii_affine'], view_affines)


@torch.no_grad()
def eval_step(spec: StageSpec, unet, atms, batch, generator=None, with_aug=False):
    """Forward-only step: loss, per-class dice, dense predictions, and the view
    geometry (thetas, slice affines) and model input for logging and output.
    Augmentation draws come from ``generator`` when ``with_aug``."""
    loss, aux = forward(spec, unet, atms, batch, generator if with_aug else None)
    num_eval = 2 if spec.use_binarized_labels else spec.num_classes
    pred, dice = metrics_from_logits(aux['logits'], aux['target_onehot'], num_eval)
    return {'loss': loss, 'dice': dice, 'pred': pred, 'thetas': aux['thetas'],
            'grid_affines': aux['grid_affines'], 'out_nii_affines': aux['out_nii_affines'],
            'b_input': aux['b_input']}
