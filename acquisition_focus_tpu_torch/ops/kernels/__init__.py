"""Wrappers of the port's CUDA kernels, one module per replaced Pallas kernel.

Each wrapper takes its kernel's plain PyTorch version for CPU tensors only; for
CUDA tensors it launches the kernel (built from ``csrc/`` on first use) or raises.
"""

import torch


def affine_coefficients(theta, out_dhw, in_dhw):
    """(T, 3, 4) float32 coefficients mapping output voxel (d, h, w) to continuous
    source voxel coordinates i_r = c0 + cd*d + ch*h + cw*w, rows r = (x->W, y->H,
    z->D), under align_corners=False; differentiable in theta (plain torch ops).
    The kernels' form of a grid-space affine, as ``_coeffs_from_theta`` in the JAX
    package's Pallas kernels."""
    do, ho, wo = (float(s) for s in out_dhw)
    D, H, W = in_dhw
    a = theta[:, :3, :4].float()
    s0 = (a[..., 0] * (1.0 / wo - 1.0) + a[..., 1] * (1.0 / ho - 1.0)
          + a[..., 2] * (1.0 / do - 1.0) + a[..., 3])
    # the sizes as Python scalars: a tensor made from a list would be a blocking
    # copy to the device, which waits for the stream on every call
    rows = [torch.stack([((s0[:, r] + 1.0) * n - 1.0) / 2.0, a[:, r, 2] * (n / do),
                         a[:, r, 1] * (n / ho), a[:, r, 0] * (n / wo)], dim=-1)
            for r, n in enumerate((float(W), float(H), float(D)))]
    return torch.stack(rows, dim=1)
