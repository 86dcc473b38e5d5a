"""K1: plane re-embedding of the skip connectors, forward and backward
(``csrc/plane_resample.cu``; replaces the JAX package's
``ops/pallas/plane_resample.py::plane_resample_pallas``).

Plain version: ``ops.resample.sample_slice_into_volume`` with its autograd gradient.
"""

import functools

import torch

from acquisition_focus_tpu_torch.ops.kernels import _lib, affine_coefficients
from acquisition_focus_tpu_torch.ops.resample import sample_slice_into_volume

_DTYPES = (torch.float32, torch.bfloat16)


def plane_resample_fwd(slices, coefs, out_spat):
    """Kernel launch: (B, C, S, S) slices, (B, 3, 4) f32 coefs ->
    (B, C, out_spat^3) volume in ``slices.dtype``."""
    B, C, S, S2 = slices.shape
    _lib.check_cuda_tensor('slices', slices, _DTYPES)
    _lib.check_cuda_tensor('coefs', coefs, (torch.float32,))
    if S != S2 or coefs.shape != (B, 3, 4) or coefs.device != slices.device:
        raise ValueError(f"bad shapes: slices {tuple(slices.shape)}, "
                         f"coefs {tuple(coefs.shape)}")
    out = torch.empty((B, C, out_spat, out_spat, out_spat), dtype=slices.dtype,
                      device=slices.device)
    _lib.launch('plane_resample_fwd', 'afk_plane_resample_fwd',
                slices.data_ptr(), coefs.data_ptr(), out.data_ptr(),
                B, C, S, out_spat, int(slices.dtype == torch.bfloat16))
    return out


@functools.lru_cache(maxsize=None)
def _bwd_workspace_floats(B, C, S):
    return _lib.library().afk_plane_resample_bwd_workspace(B, C, S)


def plane_resample_bwd(slices, coefs, grad):
    """Kernel launch: cotangent (B, C, So, So, So) in ``slices.dtype`` ->
    (d_slices (B, C, S, S) float32, d_coefs (B, 3, 4) float32). The cotangent is
    read only in the band |ix - S/2| <= 1; no atomics, so the same bits every run."""
    B, C, S, _ = slices.shape
    So = grad.shape[-1]
    _lib.check_cuda_tensor('slices', slices, _DTYPES)
    _lib.check_cuda_tensor('coefs', coefs, (torch.float32,))
    _lib.check_cuda_tensor('grad', grad, (slices.dtype,))
    if grad.shape != (B, C, So, So, So) or coefs.shape != (B, 3, 4) \
            or not grad.device == coefs.device == slices.device:
        raise ValueError(f"bad shapes or devices: cotangent {tuple(grad.shape)} on "
                         f"{grad.device}, coefs {tuple(coefs.shape)} on {coefs.device}")
    ws = torch.empty(_bwd_workspace_floats(B, C, S),
                     dtype=torch.float32, device=slices.device)
    d_slices = torch.empty((B, C, S, S), dtype=torch.float32, device=slices.device)
    d_coefs = torch.empty((B, 3, 4), dtype=torch.float32, device=slices.device)
    _lib.launch('plane_resample_bwd', 'afk_plane_resample_bwd',
                slices.data_ptr(), coefs.data_ptr(), grad.data_ptr(), ws.data_ptr(),
                d_slices.data_ptr(), d_coefs.data_ptr(),
                B, C, S, So, int(slices.dtype == torch.bfloat16))
    return d_slices, d_coefs


class _PlaneResample(torch.autograd.Function):
    """Takes the coefficients, not theta: autograd chains d_coefs -> d_theta
    through the plain torch coefficient map, as the JAX rule does with jax.vjp."""

    @staticmethod
    def forward(ctx, slices, coefs, out_spat):
        ctx.save_for_backward(slices, coefs)
        return plane_resample_fwd(slices, coefs, out_spat)

    @staticmethod
    def backward(ctx, grad):
        slices, coefs = ctx.saved_tensors
        d_slices, d_coefs = plane_resample_bwd(
            slices, coefs, grad.to(slices.dtype).contiguous())
        return d_slices.to(slices.dtype), d_coefs, None


def plane_resample(slices, theta, out_spat):
    """Re-embed (B, C, S, S) planes into (B, C, out_spat^3) volumes along the
    (B, 4, 4) grid-space affines ``theta``; differentiable in both.

    CUDA tensors: the K1 kernels. CPU tensors: the plain version
    (``sample_slice_into_volume``)."""
    if not slices.is_cuda:
        return sample_slice_into_volume(slices, theta, out_spat)
    S = slices.shape[-1]
    coefs = affine_coefficients(theta, (out_spat,) * 3, (S, S, S)).contiguous()
    return _PlaneResample.apply(slices.contiguous(), coefs, out_spat)
