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
Under ``model_type`` 'hybrid-EPix2Vox' / 'hybrid-Pix2Vox' the reconstruction model
is ``EPix2VoxModel128``: the slices enter through its interface adapters (the
views' foreground at 224^2, occupancy out as a background/foreground stack).
Under ``rotate_slice_to_min_principle`` each slice is turned to its content's
min-inertia axis; under ``label_slice_type='from-segmented'`` an evaluation step
given the frozen segmenter replaces the label slices by the segmented image
slices (:func:`segment_slices`).
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
from acquisition_focus_tpu_torch.engine.segmenter import flip_tta_logits
from acquisition_focus_tpu_torch.models.atm import (
    AffineTransformModule, apply_stacked_atms)
from acquisition_focus_tpu_torch.models.epix2vox import (
    EPix2VoxModel128, epix2vox_interface_input, epix2vox_interface_output, init_weights)
from acquisition_focus_tpu_torch.models.hybrid_unet import Conv3x3x3, HybridUnet
from acquisition_focus_tpu_torch.ops.affine import compose
from acquisition_focus_tpu_torch.ops.resample import (
    image_resize, nifti_grid_sample, nifti_grid_sample_nodiff, resize_trilinear)
from acquisition_focus_tpu_torch.ops.rotations import random_affine_batch
from acquisition_focus_tpu_torch.parallel.collectives import (
    data_gather, data_mean, sync_gradients)
from acquisition_focus_tpu_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Static stage description; the same fields as the JAX package's StageSpec
    (``atm_remat``, ``unet_remat`` and ``decoder_save_names`` set the recompute
    regions as there: ``models/recompute.py``)."""
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


EPIX2VOX_TYPES = ('hybrid-EPix2Vox', 'hybrid-Pix2Vox')


def _check_ported(spec):
    # an unknown model type: the JAX package builds the hybrid U-Net for it
    if spec.model_type not in ('hybrid-unet',) + EPIX2VOX_TYPES:
        raise NotImplementedError(f"not ported yet: model_type={spec.model_type!r}")


def resolve_device(device=None):
    """The device an entry point runs on: ``None`` is the card. Without CUDA only
    an explicit CPU device is taken; nothing falls back to the CPU by itself."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False): pass "
                           "device='cpu' to run on the CPU")
    return device


def make_models(spec: StageSpec, device=None):
    """(reconstruction model, nn.ModuleList of n_views AffineTransformModules) on
    ``device`` (``None``: the card; see :func:`resolve_device`). The reconstruction
    model is the hybrid U-Net, or ``EPix2VoxModel128`` under an (E)Pix2Vox
    ``model_type`` (its widths are fixed: ``base_features`` and ``compute_dtype``
    do not apply to it)."""
    _check_ported(spec)
    device = resolve_device(device)
    if spec.model_type in EPIX2VOX_TYPES:
        unet = EPix2VoxModel128(spec.n_views,
                                use_epix2vox=spec.model_type == 'hybrid-EPix2Vox')
    else:
        unet = HybridUnet(spec.n_views, spec.num_classes, tuple(spec.base_features),
                          dtype=spec.dtype, use_pallas_conv=spec.use_pallas_conv3d,
                          remat_skips=spec.unet_remat,
                          decoder_save_names=tuple(spec.decoder_save_names))
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
    unit norm scales; an EPix2Vox model takes its own Kaiming init
    (``models.epix2vox.init_weights``). Draws come from ``generator`` (CPU) in
    module order, the reconstruction model's first."""
    def lecun_normal(w, fan_in):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        t = torch.empty(w.shape)
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        w.copy_(t)

    modules = list(unet.modules()) + list(atms.modules())
    if isinstance(unet, EPix2VoxModel128):
        init_weights(unet, generator)
        modules = list(atms.modules())
    for m in modules:
        if isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
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
    return apply_stacked_atms(atms, prescan, spec.view_train_mask(), spec.atm_remat)


def augment_affines(spec: StageSpec, generator, n, device, data_shard=None):
    """``n`` samples' orientation augmentation affines (n, 4, 4) from ``generator``.
    ``data_shard`` (index, count): this rank holds rows index*n .. of a batch split
    over a data axis of ``count`` ranks; the draws are the whole batch's, so each
    sample gets the draws it gets on one device, and the rank keeps its rows."""
    total = n * data_shard[1] if data_shard else n
    aug = random_affine_batch(
        generator, total, rotation_strength=0.1 * spec.augment_strength,
        zoom_strength=0.2 * spec.augment_strength, offset_strength=0.0, device=device)
    return aug[data_shard[0] * n:(data_shard[0] + 1) * n] if data_shard else aug


def extract_view_slices(spec: StageSpec, atms, soft_label, nii_affine, view_affines,
                        augment_generator=None, cached_thetas=None, image=None,
                        data_shard=None):
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
      image: optional (B, D, H, W) intensity volume, sliced along the same planes
        without gradient.
      data_shard: (index, count) of a batch split over a data axis
        (:func:`augment_affines`).

    Returns: (slices (A, B, C, Sh, Sw), grid_affines (A, B, 4, 4),
              out_nii_affines (A, B, 4, 4), thetas (A, B, 4, 4),
              image slices (A, B, 1, sh, sw) at ``slice_fov_vox`` or None).
    """
    A = spec.n_active_views
    B, C = soft_label.shape[:2]
    if augment_generator is not None:
        aug = augment_affines(spec, augment_generator, B, soft_label.device, data_shard)
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
    if spec.rotate_slice_to_min_principle:
        # turn each slice so that its content's min-inertia axis lies in-plane
        # along the principal direction; no gradient through the alignment
        from acquisition_focus_tpu_torch.geometry.moments import (
            slice_min_principal_align_affines)
        with torch.no_grad():
            align = slice_min_principal_align_affines(slices.argmax(dim=1))
        slices, _, out_nii = nifti_grid_sample(slices, out_nii,
                                               pre_grid_sample_affine=align)
        grid_affines = compose(grid_affines, align)
    Sh, Sw, Sd = spec.slice_fov_vox
    slices = slices.reshape(A, B, C, Sh, Sw, Sd)[..., 0]
    Hh, Hw = spec.hires_fov_vox[:2]
    if (Sh, Sw) != (Hh, Hw):
        # upsample to the hires in-plane resolution
        up = resize_trilinear(_fold(slices)[..., None], (Hh, Hw, 1))[..., 0]
        slices = up.reshape(A, B, C, Hh, Hw)

    image_slices = None
    if image is not None:
        with torch.no_grad():
            img, _, _ = nifti_grid_sample(image[:, None], nii_affine, spec.slice_fov_mm,
                                          spec.slice_fov_vox,
                                          pre_grid_sample_affine=_fold(pre))
        image_slices = img.reshape(A, B, 1, Sh, Sw)
    return (slices, grid_affines.reshape(A, B, 4, 4), out_nii.reshape(A, B, 4, 4), thetas,
            image_slices)


def assemble_model_input(spec: StageSpec, slices, grid_affines, augment_generator=None,
                         data_shard=None):
    """Duplicate the last active view into the missing ones and stack the views on
    the channel axis: (B, V*C, S, S) input + (V, B, 4, 4) affines."""
    A, V = spec.n_active_views, spec.n_views
    idx = list(range(A)) + [A - 1] * (V - A)
    slices = slices[idx]
    grid_affines = grid_affines[idx]
    if augment_generator is not None:
        aug = augment_affines(spec, augment_generator, slices.shape[1], slices.device,
                              data_shard)
        grid_affines = compose(grid_affines, aug[None])
    return torch.cat(list(slices), dim=1), grid_affines


@torch.no_grad()
def segment_slices(spec: StageSpec, segmenter, image_slices, train_spacing_mm=1.5):
    """Label slices from the frozen segmenter on the image slices, for
    from-segmented evaluation.

    Each slice is respaced to the segmenter's ``train_spacing_mm`` grid (the factor
    from the static slice FOV, as the JAX package's jitted step has it; exact
    without learned zoom), z-normalized on its own, segmented as one tile with the
    mean of the 2^2 in-plane flips, argmax'd, one-hot encoded, and resized to the
    hires in-plane grid ('linear', as ``jax.image.resize``).

    Args: image_slices (A, B, 1, sh, sw) at ``slice_fov_vox``.
    Returns: (A, B, num_classes, Hh, Hw) float32 one-hot slices.
    """
    A, B = image_slices.shape[:2]
    sh, sw = spec.slice_fov_vox[:2]
    x = image_slices.reshape(A * B, 1, sh, sw).float()
    nh = max(1, int(round(sh * (spec.slice_fov_mm[0] / sh) / train_spacing_mm)))
    nw = max(1, int(round(sw * (spec.slice_fov_mm[1] / sw) / train_spacing_mm)))
    if (nh, nw) != (sh, sw):
        x = image_resize(x, (A * B, 1, nh, nw), 'linear')
    var, mu = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    x = (x - mu) / torch.clamp(torch.sqrt(var), min=1e-8)

    logits = flip_tta_logits(segmenter, x)
    onehot = F.one_hot(logits.argmax(dim=1), spec.num_classes).movedim(-1, 1).float()
    Hh, Hw = spec.hires_fov_vox[:2]
    if (nh, nw) != (Hh, Hw):
        onehot = image_resize(onehot, (A * B, spec.num_classes, Hh, Hw), 'linear')
    return onehot.reshape(A, B, spec.num_classes, Hh, Hw)


def forward(spec: StageSpec, unet, atms, batch, augment_generator=None, train=True,
            segmenter=None, data_shard=None):
    """Volumes -> view slices -> reconstruction -> loss.

    ``batch``: 'label' (B, D, H, W) int, 'nii_affine' (B, 4, 4),
    'view_affines' (V, B, 4, 4), under ``theta_source='cached'`` 'thetas'
    (A, B, 4, 4), and for the segmenter 'image' (B, D, H, W). Augmentation draws
    come from ``augment_generator`` (None: no augmentation). Under
    ``label_slice_type='from-segmented'``, when not ``train`` and given a
    ``segmenter``, the model sees the segmented image slices in place of the label
    slices. ``data_shard``: (index, count) of a batch split over a data axis."""
    label = batch['label']
    nii_affine = batch['nii_affine']
    view_affines = batch['view_affines'][:spec.n_active_views]
    onehot = F.one_hot(label.long(), spec.num_classes).movedim(-1, 1).float()

    aug_in = augment_generator if spec.augment_input else None
    aug_re = augment_generator if spec.augment_recon else None
    use_segmenter = (spec.label_slice_type == 'from-segmented' and not train
                     and segmenter is not None)
    slices, grid_affines, out_nii, thetas, image_slices = extract_view_slices(
        spec, atms, onehot, nii_affine, view_affines, aug_in, batch.get('thetas'),
        image=batch['image'] if use_segmenter else None, data_shard=data_shard)
    if use_segmenter:
        slices = segment_slices(spec, segmenter, image_slices)
    b_input, grid_affines_full = assemble_model_input(spec, slices, grid_affines, aug_re,
                                                      data_shard)
    if spec.model_type in EPIX2VOX_TYPES:
        logits = epix2vox_interface_output(
            unet(epix2vox_interface_input(b_input, spec.n_views)))
    else:
        logits = unet(b_input, grid_affines_full)

    target, y_hat = onehot, logits
    if spec.use_binarized_labels:
        target, y_hat = binarize_onehot(target), binarize_onehot(y_hat)
    if spec.optimize_lv_only and spec.lv_class >= y_hat.shape[1]:
        # binarized labels have no LV channel: the JAX package's gather clamps the
        # index to the last channel (the foreground) and the gather's gradient
        # drops the out-of-range index, so that channel enters the loss without
        # a gradient (PARITY.md)
        loss = dice_ce_loss(torch.cat([y_hat[:, :1], y_hat[:, -1:].detach()], dim=1),
                            target[:, [0, -1]])
    elif spec.optimize_lv_only:
        sel = [0, spec.lv_class]
        loss = dice_ce_loss(y_hat[:, sel], target[:, sel])
    else:
        loss = dice_ce_loss(y_hat, target)
    aux = {'logits': y_hat, 'target_onehot': target, 'grid_affines': grid_affines_full,
           'out_nii_affines': out_nii, 'thetas': thetas, 'b_input': b_input}
    return loss, aux


def train_step(spec: StageSpec, unet, atms, recon_opt, trans_opt, batch,
               augment_generator=None, mesh=None):
    """One optimizer update over ``num_grad_accum_steps`` microbatches.

    ``recon_opt``/``trans_opt``: (optimizer, scheduler) pairs from
    ``engine.optimizers``. ``batch`` leaves have a leading (accum, ...) axis.
    Returns {'loss': mean microbatch loss, 'dice': (accum*B, classes)}.

    ``mesh`` (``parallel.make_mesh``): ``batch`` is this rank's slice of the
    step's batch over 'data' (``parallel.shard_batch``) and the models are
    sharded (``parallel.shard_params``). The augmentation draws are the whole
    batch's; after the accumulation loop the gradients are averaged over 'data'
    (``parallel.collectives.sync_gradients``); the loss and dice returned are the
    whole batch's, in the one-device order.

    The step runs in the span ``af.step`` (``utils/spans.py``), each microbatch's
    forward and backward in ``af.forward`` and ``af.backward``, the gradient
    average over 'data' in ``af.grad_sync``, the gradient mask and both updates in
    ``af.optimizer``."""
    with spans.step():
        return _train_step(spec, unet, atms, recon_opt, trans_opt, batch,
                           augment_generator, mesh)


def _train_step(spec, unet, atms, recon_opt, trans_opt, batch, augment_generator, mesh):
    accum = spec.num_grad_accum_steps
    data_shard = None
    if mesh is not None and 'data' in mesh.shape:
        data_shard = (mesh.axis_index('data'), mesh.axis_size('data'))
    num_eval = 2 if spec.use_binarized_labels else spec.num_classes
    for opt, _ in (recon_opt, trans_opt):
        opt.zero_grad(set_to_none=True)

    losses, dices = [], []
    for i in range(accum):
        micro = {k: v[i] for k, v in batch.items()}
        with spans.span('af.forward'):
            loss, aux = forward(spec, unet, atms, micro, augment_generator,
                                data_shard=data_shard)
        with spans.span('af.backward'):
            (loss / accum).backward()
        with torch.no_grad():
            _, dice = metrics_from_logits(aux['logits'], aux['target_onehot'], num_eval)
        losses.append(loss.detach())
        dices.append(dice)
        del loss, aux

    if mesh is not None:
        with spans.span('af.grad_sync'):
            sync_gradients(mesh, (unet, atms))

    with spans.span('af.optimizer'):
        # per-view trainability: frozen (and inactive) views get no gradient and
        # so no AdamW update — no weight decay either
        full_mask = np.zeros(spec.n_views, bool)
        full_mask[:spec.n_active_views] = spec.view_train_mask()
        for v in np.flatnonzero(~full_mask):
            for p in atms[v].parameters():
                p.grad = None
        for opt, sched in (recon_opt,) + ((trans_opt,) if full_mask.any() else ()):
            opt.step()
            sched.step()
    loss, dice = torch.stack(losses).mean(), torch.stack(dices)
    if data_shard is not None:
        loss, dice = data_mean(loss, mesh), data_gather(dice, mesh, dim=1)
    return {'loss': loss, 'dice': dice.reshape(-1, dice.shape[-1])}


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
def eval_step(spec: StageSpec, unet, atms, batch, generator=None, with_aug=False,
              segmenter=None, mesh=None, data_shard=None):
    """Forward-only step: loss, per-class dice, dense predictions, and the view
    geometry (thetas, slice affines) and model input for logging and output.
    Augmentation draws come from ``generator`` when ``with_aug``; ``segmenter``: the
    frozen segmenter of from-segmented runs (see :func:`forward`). Under a
    ``mesh`` with ``data_shard`` (index, count), ``batch`` is this rank's slice of
    the batch over 'data' and the outputs are gathered to the whole batch's."""
    loss, aux = forward(spec, unet, atms, batch, generator if with_aug else None,
                        train=False, segmenter=segmenter, data_shard=data_shard)
    num_eval = 2 if spec.use_binarized_labels else spec.num_classes
    pred, dice = metrics_from_logits(aux['logits'], aux['target_onehot'], num_eval)
    out = {'loss': loss, 'dice': dice, 'pred': pred, 'thetas': aux['thetas'],
           'grid_affines': aux['grid_affines'], 'out_nii_affines': aux['out_nii_affines'],
           'b_input': aux['b_input']}
    if data_shard is not None:
        out = {k: data_mean(v, mesh) if k == 'loss' else
               data_gather(v, mesh, 1 if k in ('thetas', 'grid_affines', 'out_nii_affines')
                           else 0)
               for k, v in out.items()}
    return out
