"""Plain geometry of the training step: affines, the trilinear resampler, the
re-embedding of a plane into a volume, rotations and the augmentation draws.

Semantics (``F.affine_grid`` + ``F.grid_sample``, ``align_corners=False``, zero
padding): output voxel (d, h, w) of a (Do, Ho, Wo) grid has normalized
coordinates g = ((2w+1)/Wo - 1, (2h+1)/Ho - 1, (2d+1)/Do - 1) (x->W, y->H, z->D);
the sample point s = theta[:3] @ (g, 1) maps to input voxel i = ((s + 1) N - 1) / 2.
A sample's cell is floor(i + 2^-14) with its fraction clamped at 0, so a sample
on a voxel knot takes the one-sided gradient the training step takes. The plane
re-embedding is the trilinear sample of a volume that holds the plane at
w = S // 2 and zeros elsewhere, written as a bilinear sample times the plane's
triangular weight. Everything is float32 and differentiable through autograd.
"""

import functools

import torch

_EPS = 2.0 ** -14


def compose(*mats):
    return functools.reduce(torch.matmul, mats)


def affine_zooms(mat):
    lin = mat[..., :3, :3]
    return torch.sqrt((lin * lin).sum(dim=-2))


def scale_columns(mat, scale):
    scale = torch.as_tensor(scale, dtype=mat.dtype, device=mat.device)
    ones = torch.ones(scale.shape[:-1] + (1,), dtype=mat.dtype, device=mat.device)
    return mat * torch.cat([scale, ones], dim=-1)[..., None, :]


def _reverse_axes(mat):
    perm = [2, 1, 0, 3]
    return mat[..., perm, :][..., :, perm]


def grid_affines_for_fov(nii, in_dhw, fov_mm, fov_vox, pre):
    """(grid affine, output NIfTI affine) resampling a volume with NIfTI affine
    ``nii`` (T, 4, 4) and shape ``in_dhw`` to ``fov_mm``/``fov_vox`` about its
    center, along the grid-space affines ``pre`` (T, 4, 4)."""
    dt, dev = nii.dtype, nii.device
    shape_in = torch.tensor([float(v) for v in in_dhw], dtype=dt, device=dev)
    fov_mm = torch.tensor([float(v) for v in fov_mm], dtype=dt, device=dev)
    fov_vox = torch.tensor([float(v) for v in fov_vox], dtype=dt, device=dev)
    zooms = affine_zooms(nii)
    fov_mm_in = zooms * shape_in
    grid = scale_columns(pre, ((fov_mm / fov_mm_in) / affine_zooms(pre)).flip(-1))
    out = scale_columns(_reverse_axes(grid), fov_mm_in / (fov_vox * zooms))
    top = torch.cat([out[..., :3, :3], (out[..., :3, 3:] + 1.0) / 2.0 * shape_in[:, None]],
                    dim=-1)
    out = torch.cat([top, out[..., 3:, :]], dim=-2)
    half = (-(fov_vox - 1.0) / 2.0).expand(out[..., :3, 3].shape)
    shift = torch.einsum('...ij,...jk,...k->...i', nii[..., :3, :3], out[..., :3, :3], half)
    out = compose(nii, out)
    shift = torch.cat([shift, torch.zeros_like(shift[..., :1])], -1)
    return grid, torch.cat([out[..., :3], out[..., 3:] + shift[..., None]], dim=-1)


def _centers(n, device):
    # (2i + 1) * fl(1/n) - 1, one rounding, as the training step computes it
    inv = float(torch.tensor(1.0 / n, dtype=torch.float32))
    return ((2.0 * torch.arange(n, dtype=torch.float64, device=device) + 1.0) * inv
            - 1.0).float()


def _points(theta, out_dhw, in_dhw):
    """Input voxel coordinates (ix, iy, iz), each flat (T * Do * Ho * Wo,)."""
    do, ho, wo = out_dhw
    gx = _centers(wo, theta.device)[None, None, None, :]
    gy = _centers(ho, theta.device)[None, None, :, None]
    gz = _centers(do, theta.device)[None, :, None, None]
    a = theta.float()
    out = []
    for r, n in enumerate((in_dhw[2], in_dhw[1], in_dhw[0])):
        c = a[:, r, :, None, None, None]
        s = c[:, 0] * gx + c[:, 1] * gy + c[:, 2] * gz + c[:, 3]
        out.append((((s + 1.0) * n - 1.0) / 2.0).reshape(-1))
    return out


def _cell(i):
    i0 = torch.floor(i + _EPS)
    return i0.long(), torch.clamp(i - i0, min=0.0)


def grid_sample(volume, theta, out_dhw):
    """Trilinear sample of (B, C, D, H, W) along (T, 4, 4) affines, T a multiple
    of B (row t samples volume t % B) -> (T, C, *out_dhw) float32."""
    B, C, D, H, W = volume.shape
    T = theta.shape[0]
    out_dhw = tuple(int(v) for v in out_dhw)
    n_out = out_dhw[0] * out_dhw[1] * out_dhw[2]
    ix, iy, iz = _points(theta, out_dhw, (D, H, W))
    rows = volume.float().reshape(B, C, -1).transpose(0, 1).reshape(C, -1)
    base = ((torch.arange(T, device=volume.device) % B) * (D * H * W)).repeat_interleave(n_out)
    (x0, fx), (y0, fy), (z0, fz) = _cell(ix), _cell(iy), _cell(iz)
    out = torch.zeros((C, T * n_out), dtype=torch.float32, device=volume.device)
    for dz in (0, 1):
        z = z0 + dz
        wz = fz if dz else 1.0 - fz
        for dy in (0, 1):
            y = y0 + dy
            wy = fy if dy else 1.0 - fy
            for dx in (0, 1):
                x = x0 + dx
                wx = fx if dx else 1.0 - fx
                inside = (z >= 0) & (z < D) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
                w = torch.where(inside, wz * wy * wx, torch.zeros_like(wx))
                idx = base + (z.clamp(0, D - 1) * H + y.clamp(0, H - 1)) * W + x.clamp(0, W - 1)
                out = out + rows.index_select(1, idx) * w[None]
    return out.reshape(C, T, n_out).transpose(0, 1).reshape((T, C) + out_dhw)


def nifti_resample(volume, nii, fov_mm, fov_vox, pre):
    """Trilinear resample of a volume (B, C, D, H, W) with NIfTI affines ``nii``
    (B, 4, 4) to ``fov_mm``/``fov_vox`` along ``pre`` (T, 4, 4); zero padding pads
    with the volume's minimum. -> (resampled, grid affines, output NIfTI affines)."""
    reps = pre.shape[0] // nii.shape[0]
    grid, out_nii = grid_affines_for_fov(nii.repeat(reps, 1, 1), volume.shape[2:], fov_mm,
                                         fov_vox, pre)
    lo = volume.min()
    return grid_sample(volume - lo, grid, fov_vox) + lo, grid, out_nii


def embed_plane(slices, theta, out_spat):
    """Planes (B, C, S, S) re-embedded into (B, C, So, So, So) volumes along the
    grid-space affines ``theta`` (B, 4, 4), So = ``out_spat``."""
    B, C, S, _ = slices.shape
    n_out = out_spat ** 3
    ix, iy, iz = _points(theta, (out_spat,) * 3, (S, S, S))
    plane_w = torch.clamp(1.0 - torch.abs(ix - (S // 2)), min=0.0)
    (y0, fy), (z0, fz) = _cell(iy), _cell(iz)
    rows = slices.float().reshape(B, C, -1).transpose(0, 1).reshape(C, -1)
    base = (torch.arange(B, device=slices.device) * (S * S)).repeat_interleave(n_out)
    out = torch.zeros((C, B * n_out), dtype=torch.float32, device=slices.device)
    for dz in (0, 1):
        z = z0 + dz
        wz = fz if dz else 1.0 - fz
        for dy in (0, 1):
            y = y0 + dy
            wy = fy if dy else 1.0 - fy
            inside = (z >= 0) & (z < S) & (y >= 0) & (y < S)
            w = torch.where(inside, plane_w * wz * wy, torch.zeros_like(wy))
            idx = base + z.clamp(0, S - 1) * S + y.clamp(0, S - 1)
            out = out + rows.index_select(1, idx) * w[None]
    return out.reshape(C, B, n_out).transpose(0, 1).reshape((B, C) + (out_spat,) * 3)


def _homogeneous(rot):
    out = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    out[..., :3, :3] = rot
    out[..., 3, 3] = 1.0
    return out


def rotation_from_r6(r6):
    """Zhou et al.'s continuous 6D rotation: Gram-Schmidt of two triples."""
    x = r6[..., 0:3] / torch.linalg.norm(r6[..., 0:3], dim=-1, keepdim=True)
    z = torch.linalg.cross(x, r6[..., 3:6], dim=-1)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return _homogeneous(torch.stack([x, y, z], dim=-1))


def augmentation_affines(generator, n, strength, device):
    """(n, 4, 4) input-orientation augmentation: zoom @ rotation, the rotation a
    frame perturbed by normal draws of 0.1 * strength, the zoom uniform in
    1 +- 0.1 * strength. Draws from the CPU ``generator``, in the order zoom
    (n,), axis (n, 2), frame (n, 2), offset (n, 3) (offset strength 0)."""
    zoom_u = torch.rand(n, generator=generator).to(device)
    axis_n = torch.randn(n, 2, generator=generator).to(device)
    one_n = torch.randn(n, 2, generator=generator).to(device)
    torch.randn(n, 3, generator=generator)              # offset draws, strength 0
    rot_s, zoom_s = 0.1 * strength, 0.2 * strength
    ones = torch.ones(n, 1, device=device)
    zoom = zoom_u * zoom_s - zoom_s / 2 + 1.0
    axis = torch.cat([rot_s * axis_n, ones], dim=-1)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    one = torch.cat([ones, rot_s * one_n], dim=-1)
    two = torch.linalg.cross(axis, one, dim=-1)
    two = two / torch.linalg.norm(two, dim=-1, keepdim=True)
    one = torch.linalg.cross(two, axis, dim=-1)
    rot = _homogeneous(torch.stack([one, two, axis], dim=-2))
    z = torch.diag_embed(torch.cat([zoom[:, None].expand(n, 3), ones], -1))
    return compose(z, rot)
