"""The arithmetic of the reference's convolutions and dense layers.

``Precision('float32')`` is the reference itself: plain float32 (the caller turns
TF32 off). A lower precision is the control that `correct` has to reject: every
operand of a convolution or dense layer (input and weight) is rounded to that
format in the forward pass, and the gradient that flows back into each operand is
rounded to the format's gradient twin, as a mixed-precision step would keep them;
the products and sums stay float32, as on the tensor cores. fp8 operands are
scaled per tensor by their absolute maximum (448 for e4m3, 57344 for e5m2), the
usual recipe of fp8 training.
"""

import torch
import torch.nn.functional as F

_FORMATS = {
    # name: (forward operand dtype, gradient dtype, per-tensor scaled)
    'bfloat16': (torch.bfloat16, torch.bfloat16, False),
    'fp8': (torch.float8_e4m3fn, torch.float8_e5m2, True),
}


def _round(x, dtype, scaled):
    if not scaled:
        return x.to(dtype).to(x.dtype)
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        fwd, _, scaled = _FORMATS[fmt]
        return _round(x, fwd, scaled)

    @staticmethod
    def backward(ctx, grad):
        _, bwd, scaled = _FORMATS[ctx.fmt]
        return _round(grad, bwd, scaled), None


class Precision:
    """Convolutions and dense layers in one arithmetic: ``'float32'``,
    ``'bfloat16'`` or ``'fp8'``."""

    def __init__(self, name='float32'):
        if name != 'float32' and name not in _FORMATS:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t):
        if self.name == 'float32' or t is None:
            return t
        return _Round.apply(t, self.name)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), b, **kw)

    def conv3d(self, x, w, b=None, **kw):
        return F.conv3d(self.q(x), self.q(w), b, **kw)

    def conv_transpose3d(self, x, w, b=None, **kw):
        return F.conv_transpose3d(self.q(x), self.q(w), b, **kw)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)
