"""Affine Transform Module (ATM): a learned, constrained affine correction on top
of a clinically initialized view plane (torch port of
``acquisition_focus_tpu/models/atm.py``).

The JAX package stacks all views' modules into one vmapped module with a leading
view axis; here the views are an ``nn.ModuleList`` run in a per-view loop (as the
JAX package's own ``apply_stacked_atms`` executes them).
"""

import functools

import torch
import torch.nn as nn

from acquisition_focus_tpu_torch.models import recompute
from acquisition_focus_tpu_torch.models.localization import LocalizationNet
from acquisition_focus_tpu_torch.ops.affine import compose
from acquisition_focus_tpu_torch.ops.rotations import (
    rotation_from_angle_axis, rotation_from_normal, rotation_from_r6)

_OPTIM_METHODS = {
    'angle-axis': (3, rotation_from_angle_axis),
    'normal-vector': (3, rotation_from_normal),
    'R6-vector': (6, rotation_from_r6),
}

# identity-rotation inits per parameterization
_INIT_AP = {
    'angle-axis': (0.0, 0.0, 0.0),
    'normal-vector': (0.0, 0.0, 0.0),
    'R6-vector': (1e-2, 0.0, 0.0, 0.0, 1e-2, 0.0),
}


def vox_range_for_clip(offset_clip_value, spat):
    """Width in voxels of the soft-argmax translation window."""
    lo = ((-offset_clip_value + 1.0) * spat - 1.0) / 2.0
    hi = ((offset_clip_value + 1.0) * spat - 1.0) / 2.0
    return int(round(hi - lo))


@functools.lru_cache(maxsize=None)
def _init_ap(optim_method, dtype, device):
    """The rotation parameters' identity init on ``device``, made once: a tensor
    built from a list on the card waits for everything queued before it."""
    return torch.tensor(_INIT_AP[optim_method], dtype=dtype, device=device)


def atm_theta_from_heads(head_out, optim_method, spat, offset_clip_value,
                         zoom_clip_value):
    """Localization-net outputs (B, ap + 3*vox_range + 1) -> (B, 4, 4) learned
    view affine theta = theta_t @ theta_a @ theta_z: constrained rotation,
    soft-argmax translation, tanh-clipped isotropic zoom."""
    ap_space, rot_fn = _OPTIM_METHODS[optim_method]
    vox_range = vox_range_for_clip(offset_clip_value, spat)
    B = head_out.shape[0]

    theta_ap = head_out[:, :ap_space] + _init_ap(optim_method, head_out.dtype,
                                                 head_out.device)
    theta_tp = head_out[:, ap_space:-1].reshape(B, 3, vox_range)
    theta_zp = head_out[:, -1:] + 1.0

    if optim_method == 'normal-vector':
        theta_ap = theta_ap / torch.linalg.norm(theta_ap, dim=1, keepdim=True)
    theta_a = rot_fn(theta_ap)

    positions = (torch.arange(vox_range, dtype=head_out.dtype, device=head_out.device)
                 + (spat - vox_range) // 2)
    soft_pos = (torch.softmax(theta_tp, dim=2) * positions).sum(-1)
    gs_offsets = (2.0 * soft_pos + 1.0) / spat - 1.0
    if offset_clip_value == 0.0:
        gs_offsets = 0.0 * gs_offsets
    eye = torch.eye(4, dtype=head_out.dtype, device=head_out.device)
    theta_t = torch.cat([
        torch.cat([eye[:3, :3].expand(B, 3, 3), gs_offsets[..., None]], dim=-1),
        eye[3:].expand(B, 1, 4)], dim=1)

    zoom = zoom_clip_value * -torch.tanh(theta_zp) + 1.0          # (B, 1)
    theta_z = torch.diag_embed(torch.cat([zoom.expand(B, 3), torch.ones_like(zoom)], -1))
    return compose(theta_t, theta_a, theta_z)


class AffineTransformModule(nn.Module):
    """One view's learnable transform: prescan (B, C, P, P, P) -> (B, 4, 4)."""

    def __init__(self, in_channels, optim_method='R6-vector', prescan_spat=128,
                 offset_clip_value=0.2, zoom_clip_value=0.0, locnet_width=32,
                 dtype=torch.float32):
        super().__init__()
        self.optim_method = optim_method
        self.prescan_spat = prescan_spat
        self.offset_clip_value = offset_clip_value
        self.zoom_clip_value = zoom_clip_value
        ap_space, _ = _OPTIM_METHODS[optim_method]
        vox_range = vox_range_for_clip(offset_clip_value, prescan_spat)
        self.locnet = LocalizationNet(in_channels, prescan_spat,
                                      ap_space + 3 * vox_range + 1, locnet_width,
                                      dtype)

    def forward(self, x_prescan):
        head = self.locnet(x_prescan)
        return atm_theta_from_heads(head.float(), self.optim_method, self.prescan_spat,
                                    self.offset_clip_value, self.zoom_clip_value)


def apply_stacked_atms(atms, x_prescans, train_mask=None, remat=False):
    """Run the first A views' ATMs: (A, B, C, P, P, P) prescans -> (A, B, 4, 4).

    ``train_mask`` (A bools) marks the views whose localization nets train this
    stage; the others run under ``torch.no_grad()``, so no backward graph is built
    for them (the JAX package's structural stop_gradient).

    Each training view's chain is a recompute region, as the JAX package's
    ``jax.checkpoint`` per view: ``remat`` recomputes the whole chain in
    backward; otherwise the region keeps its convolutions' outputs and
    recomputes the float32 norms, activations and pooling between them."""
    thetas = []
    for v in range(x_prescans.shape[0]):
        if train_mask is not None and not bool(train_mask[v]):
            with torch.no_grad():
                thetas.append(atms[v](x_prescans[v]))
        else:
            thetas.append(recompute.region(
                atms[v], x_prescans[v], save_ops=None if remat else recompute.CONV_OUT))
    return torch.stack(thetas)
