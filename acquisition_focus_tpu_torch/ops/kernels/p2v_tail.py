"""(E)Pix2Vox's 128^3 tail on the card (``csrc/p2v_tail.cu``): the merger's five
3^3 conv + batch norm + leaky-ReLU blocks, and the weight gradient of the
decoder's last transposed conv (``up5``).

Replaces no kernel of the JAX package, which leaves these layers to XLA: cuDNN
ran them with direct float32 kernels at a few percent of their bound (PERF.md).

The merger runs block by block (:func:`merge_convs`). Block i's conv
(:class:`_MergeBlock`, called through the model's ``MergerConv`` module) reads
the previous block's pre-norm output and applies that block's norm and
leaky-ReLU as it loads it, then writes its own pre-norm output and statistics
(mean, rstd over every axis but the channels, float32 ``(2, C)``); the last
block's norm and activation are one pointwise pass (:class:`_NormAct`). So the
saved tensors are the merger's input and each block's pre-norm output. The
statistics are a cached function of that output: the block that reads them
takes the norm's whole backward (``dy = k dz + al y + be``, with the sums of dz
and dz xhat), and returns it as the gradient of the output it read.

A norm whose ``group`` (the mesh's 'data' axis) has two or more ranks takes the
whole batch's statistics, as ``collectives.batch_norm`` does, from rows split
evenly over the ranks: each rank's additive partials (the sums of y and y^2 in
forward, of dz and dz xhat in backward) are summed over the group before their
ordered sum; the scale and shift gradients are this rank's rows' share.

``up5`` keeps cuDNN's forward and input gradient; its weight gradient is
``p2v_up_dw`` (:class:`_UpConv`).

Every piece has its plain version for CPU tensors, which the CPU tests drive
through the same functions; the model routes only CUDA float32 tensors here.
Launches count under ``launch.p2v_*``.
"""

import math

import torch
import torch.nn.functional as F

from acquisition_focus_tpu_torch.ops.kernels import _lib
from acquisition_focus_tpu_torch.parallel.collectives import all_reduce_sum

UP_STRIDE, UP_PADDING = 2, 1
UP_KERNEL_SHAPE = (32, 8, 4, 4, 4)     # the weight (Ci, Co, 4, 4, 4) p2v_up_dw computes

_ROWS_FWD, _ROWS_DW, _ROWS_NORM, _ROWS_UP = 0, 1, 2, 3
_NORM_ACT, _NORM_REDUCE, _NORM_APPLY = 0, 1, 2
_SUM_PLAIN, _SUM_STATS, _SUM_BACKWARD = 0, 1, 2


def _rows(kind, n, ci, co, dhw):
    return int(_lib.library().afk_p2v_rows(kind, n, ci, co, *dhw))


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _check(x, weight=None, **others):
    """Contiguous CUDA float32 operands (None: absent), and a 3^3 conv weight
    whose input channels are ``x``'s: the kernels read raw pointers."""
    for name, t in dict(others, x=x, weight=weight).items():
        if t is not None:
            _lib.check_cuda_tensor(name, t, (torch.float32,))
    if weight is not None and (weight.dim() != 5 or weight.shape[1] != x.shape[1]
                               or tuple(weight.shape[2:]) != (3, 3, 3)):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x {tuple(x.shape)}")


def _ranks(group):
    """The ranks a norm's statistics span: 1 without a group."""
    return 1 if group is None else group.size()


def _total(t, group):
    """``t`` summed over the norm's group (``t`` itself on one rank)."""
    return t if _ranks(group) == 1 else all_reduce_sum(t, group)


def _sum(part, n, mode, gamma=None, st=None, count=0, out_rows=1, eps=0.0):
    """p2v_merge_sum over ``part`` (rows, ld): ``(out_rows, n)`` float32 and, for
    the backward, the (2, n) gradients of the norm's scale and shift."""
    out = torch.empty((out_rows, n), dtype=torch.float32, device=part.device)
    out2 = torch.empty((2, n), dtype=torch.float32, device=part.device) \
        if mode == _SUM_BACKWARD else None
    _lib.launch('p2v_merge_sum', 'afk_p2v_merge_sum', part.data_ptr(), part.shape[0],
                part.shape[1], n, mode, _ptr(gamma), _ptr(st), out.data_ptr(), _ptr(out2),
                count, eps)
    return out, out2


def _act(y, st, gamma, beta, slope):
    """Plain: leaky(y * sc + sh), the norm's affine form from its statistics."""
    view = (1, -1) + (1,) * (y.dim() - 2)
    sc = gamma * st[1]
    sh = beta - st[0] * sc
    return F.leaky_relu(y * sc.view(view) + sh.view(view), slope)


def _stats(y, eps, group):
    """Plain: (2, C) [mean, rstd] in y's dtype, from the sums of y and y^2 in
    float64 over every axis but 1 and over ``group``."""
    dims = (0,) + tuple(range(2, y.dim()))
    y64 = y.double()
    sums = _total(torch.stack([y64.sum(dims), (y64 * y64).sum(dims)]), group)
    mean, sq = sums / (y.numel() // y.shape[1] * _ranks(group))
    var = sq - mean * mean
    return torch.stack([mean, (var.clamp(min=0) + eps).rsqrt()]).to(y.dtype)


def block_forward(x, prev, weight, bias, eps, group=None):
    """y = conv3d(act(x), weight) + bias (3^3, padding 1) and y's statistics
    under its norm (``eps``; ``group``: the ranks they span), where act is the
    previous block's norm and leaky-ReLU (``prev`` = (st, gamma, beta, slope))
    or none (``prev`` None)."""
    if not x.is_cuda:
        a = x if prev is None else _act(x, *prev)
        y = F.conv3d(a, weight, bias, padding=1)
        return y, _stats(y, eps, group)
    N, ci, D, H, W = x.shape
    co = weight.shape[0]
    st, gamma, beta, slope = prev if prev is not None else (None, None, None, 0.0)
    _check(x, weight, bias=bias, st=st, gamma=gamma, beta=beta)
    y = torch.empty((N, co, D, H, W), dtype=x.dtype, device=x.device)
    part = torch.empty((_rows(_ROWS_FWD, N, ci, co, (D, H, W)), 2 * co), dtype=torch.float32,
                       device=x.device)
    _lib.launch('p2v_merge_fwd', 'afk_p2v_merge_fwd', x.data_ptr(), _ptr(st), _ptr(gamma),
                _ptr(beta), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), part.data_ptr(),
                N, ci, co, D, H, W, int(prev is not None), float(slope))
    stats, _ = _sum(_total(part, group), co, _SUM_STATS, count=N * D * H * W * _ranks(group),
                    out_rows=2, eps=eps)
    return y, stats


def block_input_grad(g, weight, x_shape):
    """The conv's input gradient (of act(x)) from the cotangent ``g``."""
    if not g.is_cuda:
        return torch.nn.grad.conv3d_input(x_shape, weight, g, padding=1)
    N, co, D, H, W = g.shape
    ci = weight.shape[1]
    _check(g, w=weight)
    if weight.shape[0] != co:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit g {tuple(g.shape)}")
    dx = torch.empty((N, ci, D, H, W), dtype=g.dtype, device=g.device)
    _lib.launch('p2v_merge_dx', 'afk_p2v_merge_dx', g.data_ptr(), weight.data_ptr(),
                dx.data_ptr(), N, ci, co, D, H, W)
    return dx


def block_param_grads(x, prev, g, w_shape):
    """The conv's weight gradient (``w_shape``) and bias gradient, from its input
    x (through ``prev``'s norm and activation) and the cotangent ``g``."""
    if not g.is_cuda:
        a = x if prev is None else _act(x, *prev)
        return (torch.nn.grad.conv3d_weight(a, w_shape, g, padding=1),
                g.sum(dim=(0, 2, 3, 4)))
    N, ci, D, H, W = x.shape
    co = g.shape[1]
    ncol = co * ci * 27
    st, gamma, beta, slope = prev if prev is not None else (None, None, None, 0.0)
    _check(x, g=g, st=st, gamma=gamma, beta=beta)
    if g.shape != (N, co, D, H, W):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match x {tuple(x.shape)}")
    part = torch.empty((_rows(_ROWS_DW, N, ci, co, (D, H, W)), ncol + co), dtype=torch.float32,
                       device=g.device)
    _lib.launch('p2v_merge_dw', 'afk_p2v_merge_dw', x.data_ptr(), _ptr(st), _ptr(gamma),
                _ptr(beta), g.data_ptr(), part.data_ptr(), N, ci, co, D, H, W,
                int(prev is not None), float(slope))
    sums, _ = _sum(part, ncol + co, _SUM_PLAIN)
    return sums[0, :ncol].view(w_shape), sums[0, ncol:]


def norm_act(y, st, gamma, beta, slope):
    """leaky(batch_norm(y)) from y's statistics."""
    if not y.is_cuda:
        return _act(y, st, gamma, beta, slope)
    N, C, D, H, W = y.shape
    _check(y, st=st, gamma=gamma, beta=beta)
    out = torch.empty_like(y)
    _lib.launch('p2v_merge_norm', 'afk_p2v_merge_norm', 0, y.data_ptr(), st.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), 0, out.data_ptr(), 0, N, C, D, H, W,
                _NORM_ACT, float(slope))
    return out


def _backward_coefficients(s1, s2, st, gamma, count):
    """Plain: from sum dz and sum dz xhat over ``count`` values, (k, al, be) of
    dy = k dz + al y + be."""
    s1, s2, mean, rstd = s1.double(), s2.double(), st[0].double(), st[1].double()
    k = gamma.double() * rstd
    al = -k * rstd * s2 / count
    return torch.stack([k, al, -k * s1 / count - al * mean]).to(gamma.dtype)


def norm_backward(da, y, st, gamma, beta, slope, group=None, inplace=False):
    """The backward of a = leaky(batch_norm(y)) on the batch's statistics (over
    ``group``'s ranks): (dy, dgamma, dbeta) from da, dgamma and dbeta this
    rank's rows' share. ``inplace``: dy overwrites da."""
    if not da.is_cuda:
        view = (1, -1) + (1,) * (y.dim() - 2)
        sc = gamma * st[1]
        z = y * sc.view(view) + (beta - st[0] * sc).view(view)
        dz = torch.where(z > 0, da, da * slope)
        xhat = (y - st[0].view(view)) * st[1].view(view)
        dims = (0,) + tuple(range(2, y.dim()))
        s1, s2 = dz.sum(dims), (dz * xhat).sum(dims)
        k, al, be = _backward_coefficients(*_total(torch.stack([s1, s2]), group), st, gamma,
                                           y.numel() // y.shape[1] * _ranks(group))
        dy = dz * k.view(view) + y * al.view(view) + be.view(view)
        return dy, s2, s1
    N, C, D, H, W = y.shape
    _check(y, da=da, st=st, gamma=gamma, beta=beta)
    if da.shape != y.shape:
        raise ValueError(f"cotangent {tuple(da.shape)} does not match y {tuple(y.shape)}")
    part = torch.empty((_rows(_ROWS_NORM, N, 0, C, (D, H, W)), 2 * C), dtype=torch.float32,
                       device=y.device)
    _lib.launch('p2v_merge_norm', 'afk_p2v_merge_norm', da.data_ptr(), y.data_ptr(),
                st.data_ptr(), gamma.data_ptr(), beta.data_ptr(), 0, 0, part.data_ptr(),
                N, C, D, H, W, _NORM_REDUCE, float(slope))
    count = N * D * H * W * _ranks(group)
    if _ranks(group) == 1:
        coef, grads = _sum(part, C, _SUM_BACKWARD, gamma, st, count, out_rows=3)
    else:
        # this rank's sums are its scale and shift gradients (rows [dz, dz xhat] -> [dgamma, dbeta])
        sums, _ = _sum(part, 2 * C, _SUM_PLAIN)
        grads = sums.view(2, C).flip(0)
        coef, _ = _sum(all_reduce_sum(part, group), C, _SUM_BACKWARD, gamma, st, count,
                       out_rows=3)
    dy = da if inplace else torch.empty_like(da)
    _lib.launch('p2v_merge_norm', 'afk_p2v_merge_norm', da.data_ptr(), y.data_ptr(),
                st.data_ptr(), gamma.data_ptr(), beta.data_ptr(), coef.data_ptr(),
                dy.data_ptr(), 0, N, C, D, H, W, _NORM_APPLY, float(slope))
    return dy, grads[0], grads[1]


class _MergeBlock(torch.autograd.Function):
    """(x, previous norm, weight, bias) -> (y, y's statistics); the statistics
    carry no gradient (the next block's backward takes the norm's whole)."""

    @staticmethod
    def forward(ctx, x, st, gamma, beta, slope, prev_group, weight, bias, eps, group):
        prev = None if st is None else (st, gamma, beta, slope)
        y, stats = block_forward(x, prev, weight, bias, eps, group)
        ctx.save_for_backward(x, st, gamma, beta, weight)
        ctx.slope, ctx.prev_group = slope, prev_group
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, g, _):
        x, st, gamma, beta, weight = ctx.saved_tensors
        prev = None if st is None else (st, gamma, beta, ctx.slope)
        g = g.contiguous()
        dw, db = block_param_grads(x, prev, g, weight.shape)
        dx = dgamma = dbeta = None
        if any(ctx.needs_input_grad[:4]):
            da = block_input_grad(g, weight, x.shape)
            if prev is None:
                dx = da
            else:
                dx, dgamma, dbeta = norm_backward(da, x, st, gamma, beta, ctx.slope,
                                                  ctx.prev_group, inplace=True)
        return dx, None, dgamma, dbeta, None, None, dw, db, None, None


class _NormAct(torch.autograd.Function):
    """The last block's norm and leaky-ReLU from its statistics."""

    @staticmethod
    def forward(ctx, y, st, gamma, beta, slope, group):
        ctx.save_for_backward(y, st, gamma, beta)
        ctx.slope, ctx.group = slope, group
        return norm_act(y, st, gamma, beta, slope)

    @staticmethod
    def backward(ctx, da):
        y, st, gamma, beta = ctx.saved_tensors
        dy, dgamma, dbeta = norm_backward(da.contiguous(), y, st, gamma, beta, ctx.slope,
                                          ctx.group)
        return dy, None, dgamma, dbeta, None, None


def merge_block(x, prev, weight, bias, eps, group):
    """One merger block's conv on the previous block's pre-norm output: ``prev``
    is that block's norm as (statistics, scale, shift, slope, group), all but
    the slope None for the first block; ``eps`` and ``group`` are this block's
    norm's. Returns (y, y's statistics)."""
    return _MergeBlock.apply(x.contiguous(), *prev, weight, bias, eps, group)


def merge_convs(x, convs, norms, slope):
    """The merger's blocks: leaky(norm_i(conv_i(.))) in turn over x, through each
    conv module called with the previous block's norm and its own
    (``MergerConv``)."""
    prev = (None, None, None, slope, None)
    for conv, norm in zip(convs, norms):
        x, st = conv(x, prev, norm)
        prev = (st, norm.weight, norm.bias, slope, norm.group)
    return _NormAct.apply(x, *prev)


def up_weight_grad(x, g, w_shape):
    """The weight gradient (``w_shape``: Ci, Co, 4, 4, 4) of the decoder's last
    transposed conv from x (N, Ci, D, H, W) and the cotangent g (N, Co, 2D, 2H,
    2W) of its output; ``p2v_up_dw`` computes it for up5's (32, 8) alone."""
    if not x.is_cuda:
        return torch.ops.aten.convolution_backward(
            g, x, x.new_empty(w_shape), None, [UP_STRIDE] * 3, [UP_PADDING] * 3, [1] * 3,
            True, [0] * 3, 1, [False, True, False])[1]
    N, ci, D, H, W = x.shape
    _lib.check_cuda_tensor('x', x, (torch.float32,))
    _lib.check_cuda_tensor('g', g, (torch.float32,))
    if tuple(w_shape) != UP_KERNEL_SHAPE or g.shape != (N, UP_KERNEL_SHAPE[1], 2 * D, 2 * H, 2 * W):
        raise ValueError(f"p2v_up_dw computes a {UP_KERNEL_SHAPE} weight gradient; got "
                         f"{tuple(w_shape)} from x {tuple(x.shape)}, g {tuple(g.shape)}")
    part = torch.empty((_rows(_ROWS_UP, N, ci, UP_KERNEL_SHAPE[1], (D, H, W)),
                        math.prod(UP_KERNEL_SHAPE)), dtype=torch.float32, device=x.device)
    _lib.launch('p2v_up_dw', 'afk_p2v_up_dw', x.data_ptr(), g.data_ptr(), part.data_ptr(),
                N, D, H, W)
    sums, _ = _sum(part, part.shape[1], _SUM_PLAIN)
    return sums.view(UP_KERNEL_SHAPE)


class _UpConv(torch.autograd.Function):
    """up5: cuDNN's transposed conv and input gradient, ``p2v_up_dw``'s weight
    gradient."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return F.conv_transpose3d(x, weight, None, stride=UP_STRIDE, padding=UP_PADDING)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, x, weight, None, [UP_STRIDE] * 3, [UP_PADDING] * 3, [1] * 3, True,
                [0] * 3, 1, [True, False, False])[0]
        return dx, up_weight_grad(x.contiguous(), g, weight.shape)


def up_conv(x, weight):
    """The decoder's last transposed conv (4^3, stride 2, padding 1, no bias)."""
    return _UpConv.apply(x, weight)
