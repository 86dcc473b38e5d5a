"""K2: forward-only trilinear affine volume resample of the prescan path
(``csrc/volume_resample.cu``; replaces the JAX package's
``ops/pallas/volume_resample.py::affine_volume_resample_pallas``).

Plain version: ``ops.resample.grid_sample(..., mode='trilinear')``.
"""

import torch

from acquisition_focus_tpu_torch.ops.kernels import _lib, affine_coefficients
from acquisition_focus_tpu_torch.ops.resample import grid_sample

_DTYPES = (torch.float32, torch.bfloat16)


def volume_resample_cuda(volume, theta, out_dhw):
    """Kernel launch: (B, C, D, H, W) volume, (T, 4, 4) or (T, 3, 4) affines ->
    (T, C, *out_dhw) in ``volume.dtype``; affine row t samples volume t % B."""
    B, C, D, H, W = volume.shape
    T = theta.shape[0]
    _lib.check_cuda_tensor('volume', volume, _DTYPES)
    if T % B or theta.device != volume.device:
        raise ValueError(f"theta {tuple(theta.shape)} on {theta.device} does not fit "
                         f"volume {tuple(volume.shape)} on {volume.device}")
    do, ho, wo = (int(s) for s in out_dhw)
    coefs = affine_coefficients(theta, (do, ho, wo), (D, H, W)).contiguous()
    # the kernel's channels-last copy of the volumes, channels padded to 8
    scratch = torch.empty(B * D * H * W * (-(-C // 8) * 8), dtype=volume.dtype,
                          device=volume.device)
    out = torch.empty((T, C, do, ho, wo), dtype=volume.dtype, device=volume.device)
    _lib.launch('volume_resample', 'afk_volume_resample',
                volume.data_ptr(), coefs.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                B, C, D, H, W, T, do, ho, wo, int(volume.dtype == torch.bfloat16))
    return out


@torch.no_grad()
def affine_volume_resample(volume, theta, out_dhw):
    """Forward-only trilinear affine grid sample (align_corners=False, zero
    padding). CUDA tensors: the K2 kernel; CPU tensors: the plain version."""
    if not volume.is_cuda:
        return grid_sample(volume, theta, out_dhw, mode='trilinear')
    return volume_resample_cuda(volume.contiguous(), theta, out_dhw)
