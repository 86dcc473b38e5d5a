"""Geometry-preserving volume resampling (torch port of
``acquisition_focus_tpu/ops/resample.py``).

Semantics are ``F.affine_grid`` + ``F.grid_sample`` with ``align_corners=False`` and
zero padding: output voxel (d, h, w) of a (Do, Ho, Wo) target has normalized
coordinates g = ((2w+1)/Wo - 1, (2h+1)/Ho - 1, (2d+1)/Do - 1, 1) (x->W, y->H, z->D);
the sample point s = theta[:3] @ g maps to input voxel coordinates
i = ((s + 1) * N - 1) / 2 per axis.

The trilinear sampler is written out instead of calling ``F.grid_sample``: cell
assignment uses the JAX package's epsilon-nudged floor and clamped fractions, so at
voxel knots the theta gradient takes the same one-sided subgradient as the
reference (``F.grid_sample`` takes the other one). That gradient is what trains the
views.
"""

import torch
import torch.nn.functional as F

from acquisition_focus_tpu_torch.ops.affine import (
    affine_zooms, grid_affines_for_fov, vox_to_grid_offset)

_EPS = 2.0 ** -14


def _normalized_coords(n, dtype, device):
    """Centers of n cells in [-1, 1] under align_corners=False, rounded as XLA
    compiles the JAX package's (2i + 1)/n - 1 on the CPU: one fused multiply-add
    (2i + 1) * fl(1/n) - 1 (the product is exact in float64). For n a power of two
    every form is exact; for other n the forms differ by an ulp, and an ulp decides
    a nearest sample that lands on a half-voxel tie (a 2 mm -> 1 mm resample
    puts every other voxel on one)."""
    inv_n = float(torch.tensor(1.0 / n, dtype=dtype))
    i2 = 2.0 * torch.arange(n, dtype=torch.float64, device=device) + 1.0
    return (i2 * inv_n - 1.0).to(dtype)


def _sample_points(theta, out_dhw):
    """(sx, sy, sz), each (T, Do, Ho, Wo): the output grid mapped through theta,
    in normalized input space (sx indexes W, sy H, sz D)."""
    do, ho, wo = out_dhw
    a = theta.float()
    gx = _normalized_coords(wo, a.dtype, a.device)[None, None, None, :]
    gy = _normalized_coords(ho, a.dtype, a.device)[None, None, :, None]
    gz = _normalized_coords(do, a.dtype, a.device)[None, :, None, None]

    def row(i):
        c = a[:, i, :, None, None, None]
        return c[:, 0] * gx + c[:, 1] * gy + c[:, 2] * gz + c[:, 3]

    return row(0), row(1), row(2)


def _to_vox(s, n):
    return ((s + 1.0) * n - 1.0) / 2.0


def _nudged_cell(i):
    """Epsilon-nudged floor and clamped fraction (see the JAX package's
    ``grid_sample``): i0 = floor(i + 2^-14), f = max(i - i0, 0)."""
    i0 = torch.floor(i + _EPS)
    return i0.long(), torch.clamp(i - i0, min=0.0)


def _volume_rows(volume):
    """(B, C, D, H, W) -> (C, B*D*H*W): channels-major, batch folded into the
    gathered point axis."""
    B, C = volume.shape[:2]
    return volume.reshape(B, C, -1).transpose(0, 1).reshape(C, -1)


def _batch_base(T, B, n_in, n_out, device):
    """(T*n_out,) flat offsets: affine row t samples volume t % B."""
    ids = torch.arange(T, device=device) % B
    return (ids * n_in).repeat_interleave(n_out)


def grid_sample(volume, theta, out_dhw, mode='trilinear'):
    """Affine grid sample of a batched volume, differentiable in volume and theta.

    Args:
      volume: (B, C, D, H, W).
      theta: (T, 4, 4) or (T, 3, 4), T a multiple of B; affine row t samples
        volume t % B (the volume is never duplicated).
      out_dhw: (Do, Ho, Wo).
      mode: 'trilinear' | 'nearest'.

    Returns: (T, C, Do, Ho, Wo) in ``volume.dtype``.
    """
    B, C, D, H, W = volume.shape
    T = theta.shape[0]
    if T % B:
        raise ValueError(f"theta rows ({T}) must be a multiple of the batch ({B})")
    do, ho, wo = (int(s) for s in out_dhw)
    n_out = do * ho * wo

    sx, sy, sz = _sample_points(theta[:, :3, :], (do, ho, wo))
    ix = _to_vox(sx, W).reshape(-1)
    iy = _to_vox(sy, H).reshape(-1)
    iz = _to_vox(sz, D).reshape(-1)

    rows = _volume_rows(volume)
    base = _batch_base(T, B, D * H * W, n_out, volume.device)

    if mode == 'nearest':
        xi, yi, zi = (torch.round(v).long() for v in (ix, iy, iz))
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (zi >= 0) & (zi < D)
        idx = base + (zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W \
            + xi.clamp(0, W - 1)
        vals = rows.index_select(1, idx)
        out = torch.where(valid[None], vals, torch.zeros((), dtype=vals.dtype,
                                                         device=vals.device))
    elif mode == 'trilinear':
        x0, fx = _nudged_cell(ix)
        y0, fy = _nudged_cell(iy)
        z0, fz = _nudged_cell(iz)
        out = torch.zeros((C, T * n_out), dtype=torch.float32, device=volume.device)
        for dz in (0, 1):
            wz = fz if dz else 1.0 - fz
            zi = z0 + dz
            vz = (zi >= 0) & (zi < D)
            for dy in (0, 1):
                wy = fy if dy else 1.0 - fy
                yi = y0 + dy
                vy = vz & (yi >= 0) & (yi < H)
                for dx in (0, 1):
                    wx = fx if dx else 1.0 - fx
                    xi = x0 + dx
                    v = vy & (xi >= 0) & (xi < W)
                    w = torch.where(v, wz * wy * wx, torch.zeros_like(wx))
                    idx = base + (zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W \
                        + xi.clamp(0, W - 1)
                    out = out + rows.index_select(1, idx).float() * w[None]
    else:
        raise ValueError(f"unknown mode {mode!r}")

    out = out.reshape(C, T, n_out).transpose(0, 1)
    return out.reshape(T, C, do, ho, wo).to(volume.dtype)


def _fov_geometry(volume, nii_affine, target_fov_mm, target_fov_vox,
                  pre_grid_sample_affine):
    """Shared set-up of the two NIfTI samplers: (target_fov_vox, grid_affine,
    out_nii). Several pre-affines may share one volume (T = reps * B)."""
    B, C, D, H, W = volume.shape
    in_shape = (D, H, W)
    if target_fov_vox is None:
        target_fov_vox = in_shape
    target_fov_vox = tuple(int(v) for v in target_fov_vox)
    if target_fov_mm is None:
        target_fov_mm = affine_zooms(nii_affine) * nii_affine.new_tensor(in_shape)
    target_fov_mm = torch.as_tensor(target_fov_mm, dtype=nii_affine.dtype,
                                    device=nii_affine.device)
    affine_nii = nii_affine
    if pre_grid_sample_affine is not None \
            and pre_grid_sample_affine.shape[0] != nii_affine.shape[0]:
        reps = pre_grid_sample_affine.shape[0] // nii_affine.shape[0]
        affine_nii = nii_affine.repeat(reps, 1, 1)
        if target_fov_mm.ndim > 1:
            target_fov_mm = target_fov_mm.repeat(reps, 1)
    grid_affine, out_nii = grid_affines_for_fov(
        affine_nii, in_shape, target_fov_mm, target_fov_vox, pre_grid_sample_affine)
    return target_fov_vox, grid_affine, out_nii


def nifti_grid_sample(volume, nii_affine, target_fov_mm=None, target_fov_vox=None,
                      is_label=False, pre_grid_sample_affine=None):
    """Resample a NIfTI volume to a target FOV, preserving physical geometry.

    Args:
      volume: (B, C, D, H, W); integer dtypes are sampled in float32.
      nii_affine: (B, 4, 4) vox -> RAS affine of ``volume``.
      target_fov_mm: (3,) target extent (D, H, W order); default keeps the input.
      target_fov_vox: (3,) ints; default keeps the input shape.
      is_label: nearest sampling if True, else trilinear with the min-shift, so
        zero padding pads with the volume minimum.
      pre_grid_sample_affine: optional (T, 4, 4) grid-space affines, T a multiple
        of B.

    Returns: (resampled (T, C, *target_fov_vox), grid_affine (T, 4, 4),
              out_nii_affine (T, 4, 4)).
    """
    target_fov_vox, grid_affine, out_nii = _fov_geometry(
        volume, nii_affine, target_fov_mm, target_fov_vox, pre_grid_sample_affine)
    in_dtype = volume.dtype
    if not volume.is_floating_point():
        volume = volume.float()
    if is_label:
        out = grid_sample(volume, grid_affine, target_fov_vox, mode='nearest')
    else:
        min_value = volume.min()
        out = grid_sample(volume - min_value, grid_affine, target_fov_vox) + min_value
    return out.to(in_dtype), grid_affine, out_nii


@torch.no_grad()
def nifti_grid_sample_nodiff(volume, nii_affine, target_fov_mm=None,
                             target_fov_vox=None, is_label=False,
                             pre_grid_sample_affine=None):
    """Forward-only :func:`nifti_grid_sample`: trilinear resamples go through the
    volume-resample kernel wrapper (the CUDA gather kernel for CUDA tensors, its
    plain version for CPU tensors). No gradient: the call site is the prescan
    resample feeding the localization nets."""
    from acquisition_focus_tpu_torch.ops.kernels.volume_resample import (
        affine_volume_resample)

    if is_label:
        return nifti_grid_sample(volume, nii_affine, target_fov_mm, target_fov_vox,
                                 True, pre_grid_sample_affine)
    target_fov_vox, grid_affine, out_nii = _fov_geometry(
        volume, nii_affine, target_fov_mm, target_fov_vox, pre_grid_sample_affine)
    in_dtype = volume.dtype
    if not volume.is_floating_point():
        volume = volume.float()
    min_value = volume.min()
    out = affine_volume_resample(volume - min_value, grid_affine,
                                 target_fov_vox) + min_value
    return out.to(in_dtype), grid_affine, out_nii


def crop_around_label_center(label, nii_affine, target_fov_mm, target_fov_vox,
                             image=None, center_mode='mean'):
    """Crop/resample around the foreground center of a label volume.

    Args:
      label: (B, C, D, H, W) integer-valued label volume.
      nii_affine: (B, 4, 4).
      target_fov_mm: (3,). target_fov_vox: (3,) ints (-1 keeps that axis).
      image: optional (B, C, D, H, W) intensity volume resampled with the same crop.
      center_mode: 'mean' (mass center, truncated to int) or 'minmax' (bbox center).

    Returns: (cropped_label, cropped_image_or_None, cropped_nii_affine).
    """
    if center_mode not in ('mean', 'minmax'):
        raise ValueError(f"unknown center_mode {center_mode!r}")
    B = label.shape[0]
    spatial = tuple(label.shape[2:])
    target_fov_vox = tuple(
        int(s) if int(t) == -1 else int(t) for s, t in zip(spatial, target_fov_vox))

    mask = (label != 0).any(dim=1)  # (B, D, H, W)
    grids = torch.meshgrid(*[torch.arange(n, dtype=torch.float32, device=label.device)
                             for n in spatial], indexing='ij')
    dims = (1, 2, 3)
    centers = []
    for g in grids:
        gb = g[None].expand(mask.shape)
        if center_mode == 'mean':
            c = (gb * mask).sum(dim=dims) / torch.clamp(mask.sum(dim=dims), min=1)
            c = torch.trunc(c)
        else:
            inf = torch.tensor(float('inf'), device=label.device)
            lo = torch.where(mask, gb, inf).amin(dim=dims)
            hi = torch.where(mask, gb, -inf).amax(dim=dims)
            c = torch.round((lo + hi) / 2.0)
        centers.append(c)
    center = torch.stack(centers, dim=-1)  # (B, 3) in (d, h, w) vox order

    shape_dhw = torch.tensor(spatial, dtype=torch.float32, device=label.device)
    pre = torch.eye(4, dtype=torch.float32, device=label.device).repeat(B, 1, 1)
    # grid-space translation is in (x->W, y->H, z->D) vector order => flip
    pre[:, :3, 3] = vox_to_grid_offset(center, shape_dhw).flip(-1)

    cropped_image = None
    if image is not None:
        cropped_image, _, _ = nifti_grid_sample(
            image, nii_affine, target_fov_mm, target_fov_vox,
            is_label=False, pre_grid_sample_affine=pre)
    cropped_label, _, cropped_nii = nifti_grid_sample(
        label, nii_affine, target_fov_mm, target_fov_vox,
        is_label=True, pre_grid_sample_affine=pre)
    return cropped_label, cropped_image, cropped_nii


def sample_slice_into_volume(slices, theta, out_spat):
    """Trilinearly resample a single-plane volume without materializing it.

    Equivalent to writing ``slices`` into plane w = S//2 of an (S, S, S) zero
    volume and ``grid_sample``-ing it with ``theta``: the trilinear sample
    factorizes into a bilinear (z, y) sample of the plane times the triangular
    plane weight max(0, 1 - |ix - S//2|). The plain version of the plane-resample
    kernel; differentiable in both arguments.

    Args:
      slices: (B, C, S, S), the (D, H) extent of the embedded plane.
      theta: (B, 4, 4) grid-space affine (volume -> plane space).
      out_spat: output volume edge length.

    Returns: (B, C, out_spat, out_spat, out_spat) in ``slices.dtype``.
    """
    S = slices.shape[-1]
    sx, sy, sz = _sample_points(theta[:, :3, :], (out_spat,) * 3)
    return _embed_plane(slices, _to_vox(sx, S).reshape(-1), _to_vox(sy, S).reshape(-1),
                        _to_vox(sz, S).reshape(-1), out_spat)


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: ``b`` holds
    small integers, so the product is exact in float64."""
    return (a.double() * b + c.double()).float()


def sample_slice_into_volume_from_coefs(slices, coefs, out_spat):
    """:func:`sample_slice_into_volume` with the output voxels mapped to plane
    coordinates through the (B, 3, 4) coefficient form of the affine
    (``ops.kernels.affine_coefficients``), each coordinate computed as the K1
    kernels compute it: ((c0 + cd d) + ch h) + cw w, each step one multiply-add
    rounded once to float32. The coordinates then equal the kernels' bit for bit,
    so at every kink of the gradient (plane weight, cell boundaries, clamp band)
    both take the same branch, where normalized coordinates round ~1e-5 voxel
    apart at 128^3. Differentiable in both arguments; a plain version for checking
    the kernels, on no training path."""
    r = torch.arange(out_spat, dtype=torch.float64, device=coefs.device)
    grid = (r[:, None, None], r[None, :, None], r[None, None, :])
    coords = []
    for row in range(3):
        c = coefs[:, row, :, None, None, None].float()
        i = c[:, 0]
        for j, v in enumerate(grid, 1):
            i = _fma32(c[:, j], v, i)
        coords.append(i.reshape(-1))
    return _embed_plane(slices, *coords, out_spat)


def _embed_plane(slices, ix, iy, iz, out_spat):
    """The re-embedding at the flat (B * out_spat^3,) plane coordinates ix (across
    the plane), iy and iz (along its H and D axes)."""
    B, C, S, S2 = slices.shape
    if S != S2:
        raise ValueError(f"slices must be square, got {tuple(slices.shape)}")
    n_out = out_spat ** 3
    plane_w = torch.clamp(1.0 - torch.abs(ix - (S // 2)), min=0.0)

    y0, fy = _nudged_cell(iy)
    z0, fz = _nudged_cell(iz)
    rows = _volume_rows(slices[..., None])
    base = _batch_base(B, B, S * S, n_out, slices.device)

    out = torch.zeros((C, B * n_out), dtype=torch.float32, device=slices.device)
    for dz in (0, 1):
        wz = fz if dz else 1.0 - fz
        zi = z0 + dz
        vz = (zi >= 0) & (zi < S)
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            yi = y0 + dy
            v = vz & (yi >= 0) & (yi < S)
            w = torch.where(v, plane_w * wz * wy, torch.zeros_like(wy))
            idx = base + zi.clamp(0, S - 1) * S + yi.clamp(0, S - 1)
            out = out + rows.index_select(1, idx).float() * w[None]

    out = out.reshape(C, B, n_out).transpose(0, 1)
    return out.reshape(B, C, out_spat, out_spat, out_spat).to(slices.dtype)


def resize_trilinear(x, out_dhw):
    """Half-pixel-center trilinear resize of (B, C, D, H, W), edge clamped:
    ``F.interpolate(mode='trilinear', align_corners=False)``, the semantics of the
    JAX package's ``resize_trilinear`` for the slice upsampling (it calls
    ``jax.image.resize``, which also antialiases when it shrinks; the step only
    enlarges)."""
    return F.interpolate(x, size=tuple(int(s) for s in out_dhw), mode='trilinear',
                         align_corners=False)


def _resize_weights(n_in, n_out, device):
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s 'linear' method on
    one axis: half-pixel centers, the triangle kernel widened by the shrink factor
    (antialiasing), each column normalized to sum 1, columns whose sample point
    lies outside the input zeroed."""
    inv_scale = n_in / n_out                    # 1 / scale, as a Python float
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) \
        * torch.tensor(inv_scale, dtype=f32) - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs() \
        / torch.tensor(kernel_scale, dtype=f32)
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def image_resize(x, shape, method):
    """``jax.image.resize(x, shape, method)`` for 'linear' and 'nearest': every
    axis whose size differs is resized, whatever its rank (2D and 3D images, with
    or without batch and channel axes).

    'linear' contracts each resized axis with the JAX package's weight matrix in
    float32 (integer inputs are promoted): shrinking it antialiases, as JAX does,
    where ``F.interpolate`` would not. 'nearest' takes source index
    floor((i + 0.5) * n_in / n_out), computed in float32 as JAX computes it, and
    keeps the dtype."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} must have one entry per axis of {tuple(x.shape)}")
    if method == 'nearest':
        for d, (m, n) in enumerate(zip(x.shape, shape)):
            if m != n:
                idx = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device)
                                   + 0.5) * m / n).long()
                x = x.index_select(d, idx)
        return x
    if method != 'linear':
        raise ValueError(f"unknown resize method {method!r}: 'linear' or 'nearest'")
    if not x.is_floating_point():
        x = x.float()
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            w = _resize_weights(m, n, x.device).to(x.dtype)
            x = torch.tensordot(x.movedim(d, -1), w, dims=1).movedim(-1, d)
    return x
