"""K3 and K4: the 3x3x3 stride-1 SAME conv of the decoder's full-resolution level.

K3 (``csrc/conv3d.cu``) is the forward and replaces the JAX package's
``ops/pallas/conv3d.py::conv3d_pallas``; K4 (``csrc/conv3d_wgrad.cu``) is the weight
gradient and replaces its ``conv3d_wgrad_pallas``. :func:`conv3d` wires them as the
JAX package's ``conv3d``/``conv3d_wg``/``conv3d_dx``/``conv3d_pg`` do:

  kernel_dx: the input gradient is K3 itself, on the cotangent with the spatially
             flipped, IO-swapped weights (launches counted as ``conv3d_dx``);
             otherwise the library's ``torch.nn.grad.conv3d_input``;
  kernel_dw: the weight gradient is K4; otherwise ``torch.nn.grad.conv3d_weight``.

Plain versions: ``F.conv3d(x, w, b, padding=1)`` (K3) and
``torch.nn.grad.conv3d_weight(x, w_shape, g, padding=1)`` (K4). CPU tensors take
them; CUDA tensors launch the kernels or raise.
"""

import ctypes

import torch
import torch.nn.functional as F

from acquisition_focus_tpu_torch.ops.kernels import _lib

_DTYPES = (torch.float32, torch.bfloat16)

# the JAX package's tiling constraints (ops/pallas/conv3d.py:39-47): the kernel
# engages where the Pallas kernel does, i.e. at the decoder's full-res level
_TZ, _TY = 8, 4


def supports_conv3d(x_shape, w_shape):
    """Dispatch guard, as in the JAX package: (B, Ci, D, H, W) input and
    (Co, Ci, 3, 3, 3) weight with W % 128 == 0, D % 8 == 0, H % 4 == 0."""
    if len(x_shape) != 5 or len(w_shape) != 5:
        return False
    B, Ci, D, H, W = x_shape
    if tuple(w_shape[2:]) != (3, 3, 3) or w_shape[1] != Ci:
        return False
    return W % 128 == 0 and D % _TZ == 0 and H % _TY == 0


def conv3d_fwd_cuda(x, weight, bias, count_as='conv3d_fwd'):
    """K3 launch: (B, Ci, D, H, W) x (Co, Ci, 3, 3, 3) + (Co,) -> (B, Co, D, H, W)
    in ``x.dtype`` (f32 accumulation, bias added in f32). The launch counts under
    ``count_as``."""
    B, Ci, D, H, W = x.shape
    Co = weight.shape[0]
    _lib.check_cuda_tensor('x', x, _DTYPES)
    if weight.shape != (Co, Ci, 3, 3, 3) or bias.shape != (Co,):
        raise ValueError(f"bad shapes: weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)} for x {tuple(x.shape)}")
    wt = weight.to(x.dtype).permute(2, 3, 4, 1, 0).contiguous()   # (3,3,3,Ci,Co)
    b32 = bias.float().contiguous()
    _lib.check_cuda_tensor('weight', wt, (x.dtype,))
    _lib.check_cuda_tensor('bias', b32, (torch.float32,))
    out = torch.empty((B, Co, D, H, W), dtype=x.dtype, device=x.device)
    _lib.launch(count_as, 'afk_conv3d_fwd',
                x.data_ptr(), wt.data_ptr(), b32.data_ptr(), out.data_ptr(),
                B, Ci, Co, D, H, W, int(x.dtype == torch.bfloat16))
    return out


def conv3d_wgrad_cuda(x, g):
    """K4 launch: (B, Ci, D, H, W) input and (B, Co, D, H, W) cotangent of one
    dtype -> (Co, Ci, 3, 3, 3) float32 weight gradient. Split-K over voxel rows
    into a workspace, then a fixed-order sum over the chunks (deterministic)."""
    B, Ci, D, H, W = x.shape
    Co = g.shape[1]
    _lib.check_cuda_tensor('x', x, _DTYPES)
    _lib.check_cuda_tensor('g', g, (x.dtype,))
    if g.shape != (B, Co, D, H, W):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match x {tuple(x.shape)}")
    ws = (ctypes.c_int * 2)()
    _lib.library().afk_conv3d_wgrad_workspace(B, Ci, Co, D, H, ctypes.addressof(ws))
    part = torch.empty(ws[0] * ws[1], dtype=torch.float32, device=x.device)
    dw = torch.empty((Co, Ci, 3, 3, 3), dtype=torch.float32, device=x.device)
    _lib.launch('conv3d_wgrad', 'afk_conv3d_wgrad',
                x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                B, Ci, Co, D, H, W, int(x.dtype == torch.bfloat16))
    return dw


def conv3d_wgrad(x, g):
    """Weight gradient (Co, Ci, 3, 3, 3) in float32: K4 for CUDA tensors, the
    plain version for CPU tensors."""
    if not x.is_cuda:
        w_shape = (g.shape[1], x.shape[1], 3, 3, 3)
        return torch.nn.grad.conv3d_weight(x, w_shape, g, padding=1).float()
    return conv3d_wgrad_cuda(x.contiguous(), g.contiguous())


def _forward(x, weight, bias, count_as='conv3d_fwd'):
    if not x.is_cuda:
        return F.conv3d(x, weight.to(x.dtype), bias.to(x.dtype), padding=1)
    return conv3d_fwd_cuda(x, weight, bias, count_as)


class _Conv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, kernel_dx, kernel_dw):
        ctx.save_for_backward(x, weight)
        ctx.kernel_dx, ctx.kernel_dw = kernel_dx, kernel_dw
        return _forward(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        # cast to x's dtype, so the JAX package's dtype guard on K4 always holds;
        # its shape guards (ops/pallas/conv3d.py:314-321) follow
        grad = grad.to(x.dtype).contiguous()
        w = weight.to(x.dtype)
        w_t = w.flip(2, 3, 4).transpose(0, 1)
        if ctx.kernel_dx and supports_conv3d(grad.shape, w_t.shape):
            dx = _forward(grad, w_t, grad.new_zeros(w_t.shape[0], dtype=torch.float32),
                          'conv3d_dx')
        else:
            dx = torch.nn.grad.conv3d_input(x.shape, w, grad, padding=1)
        if ctx.kernel_dw and supports_conv3d(x.shape, w.shape):
            dw = conv3d_wgrad(x, grad)
        else:
            dw = torch.nn.grad.conv3d_weight(x, weight.shape, grad, padding=1)
        db = grad.sum(dim=(0, 2, 3, 4), dtype=torch.float32)
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None, None


def conv3d(x, weight, bias, kernel_dx=False, kernel_dw=False):
    """3x3x3 SAME conv through K3, with the input gradient through K3 as well
    (``kernel_dx``) and the weight gradient through K4 (``kernel_dw``); the
    other gradients are the library's. x and weight are used in x's dtype, the
    bias is added in f32 and the result has x's dtype. CPU tensors take each
    piece's plain version."""
    return _Conv3d.apply(x.contiguous(), weight, bias, kernel_dx, kernel_dw)
