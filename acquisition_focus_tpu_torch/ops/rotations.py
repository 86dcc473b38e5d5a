"""Differentiable rotation parameterizations and random augmentation affines
(torch port of ``acquisition_focus_tpu/ops/rotations.py``).

All functions are batched over leading dimensions and return homogeneous 4x4
matrices. Training-time random draws come from a ``torch.Generator``; torch and
jax.random give different numbers from one seed, so :func:`affine_from_draws` takes
the draws explicitly and the parity tests hand both frameworks the same ones. The
dataset build's fixed draws are JAX's own (:func:`random_affine_from_jax_key`).
"""

import torch

from acquisition_focus_tpu_torch.ops.affine import compose


def _embed_3x3(rot):
    """(..., 3, 3) linear part -> homogeneous (..., 4, 4)."""
    out = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    out[..., :3, :3] = rot
    out[..., 3, 3] = 1.0
    return out


def rotation_from_r6(r6):
    """Continuous 6D rotation (Zhou et al., CVPR'19): Gram-Schmidt of the two
    triples gives the first two columns, their cross product the third.
    (..., 6) -> (..., 4, 4)."""
    x_raw, y_raw = r6[..., 0:3], r6[..., 3:6]
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y_raw, dim=-1)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return _embed_3x3(torch.stack([x, y, z], dim=-1))


def rotation_from_normal(normals):
    """Rotation whose third row is the normal (nz, ny, nx); the in-plane frame
    follows the normal's azimuth (singular for normals along z, as upstream).
    (..., 3) -> (..., 4, 4)."""
    nz, ny, nx = normals[..., 0], normals[..., 1], normals[..., 2]
    rho = torch.sqrt(nx * nx + ny * ny)
    zero = torch.zeros_like(nx)
    row0 = torch.stack([ny / rho, -nx / rho, zero], dim=-1)
    row1 = torch.stack([nx * nz / rho, ny * nz / rho, -rho], dim=-1)
    row2 = torch.stack([nx, ny, nz], dim=-1)
    return _embed_3x3(torch.stack([row0, row1, row2], dim=-2))


def rotation_from_angle_axis(angle_axis, eps=1e-6):
    """Rodrigues' formula with a first-order Taylor branch near zero rotation.
    (..., 3) -> (..., 4, 4)."""
    theta2 = (angle_axis * angle_axis).sum(dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + eps)
    w = angle_axis / (theta + eps)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    c = torch.cos(theta[..., 0])
    s = torch.sin(theta[..., 0])
    one_c = 1.0 - c

    rodrigues = torch.stack([
        torch.stack([c + wx * wx * one_c, wx * wy * one_c - wz * s,
                     wy * s + wx * wz * one_c], -1),
        torch.stack([wz * s + wx * wy * one_c, c + wy * wy * one_c,
                     -wx * s + wy * wz * one_c], -1),
        torch.stack([-wy * s + wx * wz * one_c, wx * s + wy * wz * one_c,
                     c + wz * wz * one_c], -1),
    ], dim=-2)

    rx, ry, rz = angle_axis[..., 0], angle_axis[..., 1], angle_axis[..., 2]
    one = torch.ones_like(rx)
    taylor = torch.stack([
        torch.stack([one, -rz, ry], -1),
        torch.stack([rz, one, -rx], -1),
        torch.stack([-ry, rx, one], -1),
    ], dim=-2)

    use_rodrigues = (theta2 > eps)[..., None]
    return _embed_3x3(torch.where(use_rodrigues, rodrigues, taylor))


def affine_from_draws(zoom_u, axis_n, one_n, off_n, rotation_strength=0.2,
                      zoom_strength=0.2, offset_strength=0.0):
    """Augmentation affine from its random draws: zoom @ rotation @ translation.

    Args (batched over a leading axis):
      zoom_u: (N,) uniform [0, 1) draws; axis_n, one_n: (N, 2) standard normal
      draws perturbing the frame; off_n: (N, 3) standard normal offset draws.
    Returns: (N, 4, 4).
    """
    n = zoom_u.shape[0]
    ones = torch.ones_like(zoom_u)[:, None]
    zoom = zoom_u * zoom_strength - zoom_strength / 2 + 1.0

    axis = torch.cat([rotation_strength * axis_n, ones], dim=-1)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    one = torch.cat([ones, rotation_strength * one_n], dim=-1)
    two = torch.linalg.cross(axis, one, dim=-1)
    two = two / torch.linalg.norm(two, dim=-1, keepdim=True)
    one = torch.linalg.cross(two, axis, dim=-1)

    eye = torch.eye(4, dtype=zoom_u.dtype, device=zoom_u.device).repeat(n, 1, 1)
    theta_r = eye.clone()
    theta_r[:, :3, :3] = torch.stack([one, two, axis], dim=-2)
    theta_z = torch.diag_embed(torch.cat([zoom[:, None].expand(n, 3), ones], -1))
    theta_t = eye.clone()
    theta_t[:, :3, 3] = offset_strength * off_n
    return compose(theta_z, theta_r, theta_t)


def random_affine_batch(generator, batch, rotation_strength=0.2, zoom_strength=0.2,
                        offset_strength=0.0, dtype=torch.float32, device=None):
    """(batch, 4, 4) independent augmentation affines drawn from ``generator``
    (a CPU ``torch.Generator``: the draws are a few numbers; the affines are built
    on ``device``)."""
    def draw(fn, *shape):
        return fn(*shape, generator=generator, dtype=dtype).to(device)

    return affine_from_draws(
        draw(torch.rand, batch), draw(torch.randn, batch, 2),
        draw(torch.randn, batch, 2), draw(torch.randn, batch, 3),
        rotation_strength, zoom_strength, offset_strength)


def random_affine(generator, rotation_strength=0.2, zoom_strength=0.2,
                  offset_strength=0.0, dtype=torch.float32, device=None):
    """One augmentation affine, (4, 4)."""
    return random_affine_batch(generator, 1, rotation_strength, zoom_strength,
                               offset_strength, dtype, device)[0]


def random_affine_from_jax_key(key, rotation_strength=0.2, zoom_strength=0.2,
                               offset_strength=0.0):
    """The JAX package's ``random_affine(key, ...)`` with its own draws: ``key`` is
    a ``utils.jax_prng`` key, split into the zoom, axis, frame and offset keys as
    ``jax.random`` splits it. (4, 4) float32 on the CPU."""
    from acquisition_focus_tpu_torch.utils import jax_prng
    k_zoom, k_axis, k_one, k_off = jax_prng.split(key, 4)
    draws = [torch.from_numpy(d) for d in (
        jax_prng.uniform(k_zoom, (1,)), jax_prng.normal(k_axis, (1, 2)),
        jax_prng.normal(k_one, (1, 2)), jax_prng.normal(k_off, (1, 3)))]
    return affine_from_draws(*draws, rotation_strength, zoom_strength,
                             offset_strength)[0]
