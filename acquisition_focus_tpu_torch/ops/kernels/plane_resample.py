"""K1: plane re-embedding of the skip connectors, forward and backward
(``csrc/plane_resample.cu``; replaces the JAX package's
``ops/pallas/plane_resample.py::plane_resample_pallas``).

One launch takes the V views of a skip level: planes (B, V*F, S, S), view v owning
channels v*F..(v+1)*F, coefficients (V, B, 3, 4) (or (B, 3, 4) for one view). The
forward writes each view's volume into channels ``c_off + v*F..`` of a caller's
buffer, and the backward reads the cotangent there in place, so the skip connector
builds the decoder's concat buffer without a ``torch.cat`` (:func:`skip_concat`).

Plain version: ``ops.resample.sample_slice_into_volume`` per view, with its
autograd gradient.
"""

import functools
from typing import Optional

import torch

from acquisition_focus_tpu_torch.models import recompute
from acquisition_focus_tpu_torch.ops.kernels import _lib, affine_coefficients
from acquisition_focus_tpu_torch.ops.resample import sample_slice_into_volume

_DTYPES = (torch.float32, torch.bfloat16)


def _views(slices, coefs):
    """(V, B, F, S) of a launch; raises on shapes the kernels do not take."""
    B, VF, S, S2 = slices.shape
    lead = tuple(coefs.shape[:-2])             # (B,) or (V, B)
    V = lead[0] if len(lead) == 2 else 1
    if S != S2 or coefs.shape[-2:] != (3, 4) or len(lead) not in (1, 2) or lead[-1] != B \
            or VF % V or coefs.device != slices.device:
        raise ValueError(f"bad shapes or devices: slices {tuple(slices.shape)} on "
                         f"{slices.device}, coefs {tuple(coefs.shape)} on {coefs.device}")
    return V, B, VF // V, S


def plane_resample_fwd(slices, coefs, out_spat, out=None, c_off=0):
    """Kernel launch: slices (B, V*F, S, S), coefs (V, B, 3, 4) or, for one view,
    (B, 3, 4) float32 -> view v, channel c re-embedded into channel
    ``c_off + v*F + c`` of ``out``, a contiguous (B, C_out, So, So, So) tensor in
    ``slices.dtype`` (So = ``out_spat``), whose other channels are left as they
    are; ``out=None``: a new (B, V*F, So, So, So) tensor. Returns ``out``."""
    _lib.check_cuda_tensor('slices', slices, _DTYPES)
    _lib.check_cuda_tensor('coefs', coefs, (torch.float32,))
    V, B, F, S = _views(slices, coefs)
    shape = (B, V * F) + (out_spat,) * 3
    if out is None:
        if c_off:
            raise ValueError("c_off needs an output buffer")
        out = torch.empty(shape, dtype=slices.dtype, device=slices.device)
    else:
        _lib.check_cuda_tensor('out', out, (slices.dtype,))
        if out.dim() != 5 or out.shape[0] != B or out.shape[2:] != shape[2:] \
                or not 0 <= c_off <= out.shape[1] - V * F or out.device != slices.device:
            raise ValueError(f"output {tuple(out.shape)} on {out.device} cannot take "
                             f"{shape} at channel {c_off}")
    _lib.launch('plane_resample_fwd', 'afk_plane_resample_fwd',
                slices.data_ptr(), coefs.data_ptr(), out.data_ptr(), out.stride(0), c_off,
                V, B, F, S, out_spat, int(slices.dtype == torch.bfloat16))
    return out


@functools.lru_cache(maxsize=None)
def _bwd_workspace_floats(V, B, F, S):
    return _lib.library().afk_plane_resample_bwd_workspace(V, B, F, S)


def plane_resample_bwd(slices, coefs, grad, c_off=0):
    """Kernel launch: the cotangent of view v, channel c is channel
    ``c_off + v*F + c`` of ``grad``, a contiguous (B, C_g, So, So, So) tensor in
    ``slices.dtype``, read in place -> (d_slices (B, V*F, S, S) float32, d_coefs
    float32 of ``coefs``' shape). The cotangent is read only in the band
    |ix - S/2| <= 1; no atomics, so the same bits every run."""
    _lib.check_cuda_tensor('slices', slices, _DTYPES)
    _lib.check_cuda_tensor('coefs', coefs, (torch.float32,))
    _lib.check_cuda_tensor('grad', grad, (slices.dtype,))
    V, B, F, S = _views(slices, coefs)
    So = grad.shape[-1]
    if grad.dim() != 5 or grad.shape[0] != B or grad.shape[2:] != (So,) * 3 \
            or not 0 <= c_off <= grad.shape[1] - V * F or grad.device != slices.device:
        raise ValueError(f"cotangent {tuple(grad.shape)} on {grad.device} holds no "
                         f"{V * F} channels at {c_off} for slices {tuple(slices.shape)}")
    ws = torch.empty(_bwd_workspace_floats(V, B, F, S),
                     dtype=torch.float32, device=slices.device)
    d_slices = torch.empty(slices.shape, dtype=torch.float32, device=slices.device)
    d_coefs = torch.empty(coefs.shape, dtype=torch.float32, device=slices.device)
    _lib.launch('plane_resample_bwd', 'afk_plane_resample_bwd',
                slices.data_ptr(), coefs.data_ptr(), grad.data_ptr(), grad.stride(0), c_off,
                ws.data_ptr(), d_slices.data_ptr(), d_coefs.data_ptr(),
                V, B, F, S, So, int(slices.dtype == torch.bfloat16))
    return d_slices, d_coefs


@torch.library.custom_op('afocus::skip_concat_fwd', mutates_args=())
def skip_concat_fwd_op(y: Optional[torch.Tensor], slices: torch.Tensor,
                       coefs: torch.Tensor, out_spat: int) -> torch.Tensor:
    """cat([y, re-embedded views], 1) in a new buffer (``y`` None: the views
    alone) with one K1f launch, as one dispatcher op, to which the profiler's
    trace links the launch."""
    out, co = None, 0
    if y is not None:
        co = y.shape[1]
        out = torch.empty((y.shape[0], co + slices.shape[1]) + (out_spat,) * 3,
                          dtype=y.dtype, device=y.device)
        out[:, :co].copy_(y)
    return plane_resample_fwd(slices, coefs, out_spat, out, co)


class _PlaneResample(torch.autograd.Function):
    """cat([y, re-embedded views], 1) in one buffer (``y`` None: the views alone),
    one K1f launch forward, one K1b launch backward reading the buffer's
    cotangent in place. Takes the coefficients, not theta: autograd chains
    d_coefs -> d_theta through the plain torch coefficient map, as the JAX rule
    does with jax.vjp."""

    @staticmethod
    def forward(ctx, y, slices, coefs, out_spat):
        ctx.save_for_backward(slices, coefs)
        ctx.co = 0 if y is None else y.shape[1]
        # a kept call site of the recompute regions: a replay takes the kept buffer
        return recompute.kept(recompute.SKIP,
                              lambda: skip_concat_fwd_op(y, slices, coefs, out_spat))

    @staticmethod
    def backward(ctx, grad):
        slices, coefs = ctx.saved_tensors
        grad = grad.contiguous()
        d_slices, d_coefs = plane_resample_bwd(slices, coefs, grad, ctx.co)
        d_y = grad[:, :ctx.co] if ctx.needs_input_grad[0] else None
        return d_y, d_slices.to(slices.dtype), d_coefs, None


def plane_resample(slices, theta, out_spat):
    """Re-embed (B, C, S, S) planes into (B, C, out_spat^3) volumes along the
    (B, 4, 4) grid-space affines ``theta``; differentiable in both.

    CUDA tensors: the K1 kernels. CPU tensors: the plain version
    (``sample_slice_into_volume``)."""
    if not slices.is_cuda:
        return sample_slice_into_volume(slices, theta, out_spat)
    S = slices.shape[-1]
    coefs = affine_coefficients(theta, (out_spat,) * 3, (S, S, S)).contiguous()
    return _PlaneResample.apply(None, slices.contiguous(), coefs, out_spat)


def skip_concat(y, slices, theta):
    """``torch.cat([y, skip], 1)``, where ``skip`` (B, V*F, S, S, S) holds the V views
    of ``slices`` (B, V*F, S, S) re-embedded along the (V, B, 4, 4) grid-space
    affines ``theta``, view v in channels v*F..(v+1)*F; ``y`` (B, co, S, S, S) in
    the slices' dtype, or None for ``skip`` alone. Differentiable in all three.

    CUDA tensors: one buffer, one K1f launch for the V views, one K1b launch
    reading the buffer's cotangent in place. CPU tensors: the plain composition
    (``sample_slice_into_volume`` per view and ``torch.cat``)."""
    if y is not None and y.dtype != slices.dtype:
        raise ValueError(f"y is {y.dtype} but the slices are {slices.dtype}")
    V, B, S = theta.shape[0], slices.shape[0], slices.shape[-1]
    if not slices.is_cuda:
        F = slices.shape[1] // V
        skip = torch.cat([sample_slice_into_volume(slices[:, v * F:(v + 1) * F], theta[v], S)
                          for v in range(V)], dim=1)
        return skip if y is None else torch.cat([y, skip], dim=1)
    coefs = affine_coefficients(theta.reshape(V * B, 4, 4), (S,) * 3, (S,) * 3)
    return _PlaneResample.apply(y, slices.contiguous(), coefs.reshape(V, B, 3, 4).contiguous(),
                                S)
