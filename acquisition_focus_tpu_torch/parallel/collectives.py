"""The collectives of the mesh, placed by hand where XLA's SPMD partitioner places
them for the JAX package.

Feature parallelism over 'model' takes Megatron's two autograd-aware forms:

* :func:`copy_to_model` sits in front of every column-parallel conv, whose input
  is replicated: the identity in forward, and in backward the sum over 'model'
  of the input gradients, each rank's from its own output features.
* :func:`gather_from_model` follows each sharded conv -> norm -> activation: the
  all-gather of the channel slices in forward, "keep my slice" in backward (the
  gradient of the gathered tensor is the same on every rank of the axis).

So every replicated tensor carries the same full gradient on every rank of the
axis, and each rank's split parameters their exact gradients. Data parallelism
over 'data' is :func:`sync_gradients` after the accumulation loop, and, for the
(E)Pix2Vox batch norms, :func:`batch_norm`: the statistics of the whole
batch, as XLA takes ``jnp.mean``/``jnp.var`` over a batch axis sharded on 'data'.

Every collective is a functional collective (``torch.ops._c10d_functional``,
with ``wait_tensor``). An all-gather is a kept call site of the recompute
regions (``models/recompute.py``, ``COLLECTIVES``): a region that keeps the
gathers keeps its output, and its replay in backward takes that output instead
of gathering a second time.

Each collective that runs counts ``collective.calls`` and its input's bytes in
``collective.bytes`` (``utils/spans.py``). An all-gather replayed from its kept
output sends nothing, so it is not counted.
"""

import torch
import torch.distributed as dist

from acquisition_focus_tpu_torch.models import recompute
from acquisition_focus_tpu_torch.parallel.mesh import is_split
from acquisition_focus_tpu_torch.utils import spans

_c10d = torch.ops._c10d_functional


def _count(x):
    spans.count('collective.calls')
    spans.count('collective.bytes', x.numel() * x.element_size())


def all_reduce_sum(x, group):
    """The sum of ``x`` over ``group`` (a new tensor)."""
    _count(x)
    return _c10d.wait_tensor(_c10d.all_reduce(x.contiguous(), 'sum', group.group_name))


def all_gather(x, group, dim):
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in rank order. A
    channels-last ``x`` gathered along its channels (dim 1) stays channels-last,
    so the ops after the gather take the path they take on one device."""
    n = group.size()
    if dim == 1 and x.ndim > 2 and not x.is_contiguous() \
            and x.movedim(1, -1).is_contiguous():
        return all_gather(x.movedim(1, -1), group, x.ndim - 1).movedim(-1, 1)

    def gather():
        _count(x)
        return _c10d.wait_tensor(_c10d.all_gather_into_tensor(x.contiguous(), n,
                                                              group.group_name))

    g = recompute.kept(recompute.COLLECTIVES, gather)
    if dim == 0:
        return g
    g = g.view((n,) + tuple(x.shape)).movedim(0, dim)
    return g.reshape(x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        # a view with x's own strides: view_as resets a size-1 axis's stride, which
        # can turn a channels-last batch of one into a contiguous conv output
        return x.as_strided(x.shape, x.stride(), x.storage_offset())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.index, ctx.width = dist.get_rank(group), x.shape[1]
        return all_gather(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.index * ctx.width, ctx.width), None


class _BatchNorm(torch.autograd.Function):
    """Batch norm of ``x`` (N, C, ...) whose rows are split over ``group``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        n = x.numel() // x.shape[1] * group.size()
        # two passes, as jnp.var: the mean, then the mean squared deviation
        mean = all_reduce_sum(x.sum(dims), group) / n
        xc = x - mean.view(shape)
        var = all_reduce_sum((xc * xc).sum(dims), group) / n
        rstd = torch.rsqrt(var + eps)
        xhat = xc * rstd.view(shape)
        ctx.save_for_backward(xhat, rstd, weight)
        ctx.group, ctx.n = group, n
        return xhat * weight.view(shape) + bias.view(shape)

    @staticmethod
    def backward(ctx, dy):
        xhat, rstd, weight = ctx.saved_tensors
        dims = (0,) + tuple(range(2, dy.ndim))
        shape = (1, -1) + (1,) * (dy.ndim - 2)
        C = dy.shape[1]
        # this rank's rows' sums: the scale and bias gradients of its loss
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        total = all_reduce_sum(local, ctx.group)
        sum_dy, sum_dy_xhat = total[:C].view(shape), total[C:].view(shape)
        dx = (weight * rstd).view(shape) / ctx.n * (
            ctx.n * dy - sum_dy - xhat * sum_dy_xhat)
        return dx, local[C:], local[:C], None, None


def batch_norm(x, weight, bias, eps, group):
    """Batch normalization of ``x`` (N, C, ...) whose rows are split evenly over
    ``group`` (the mesh's 'data' axis), on the whole batch's statistics:
    per-channel mean and biased variance over every axis but 1 and over the
    ranks, in two passes as ``jnp.var`` (an all-reduce of the sums, then of the
    squared deviations). Backward all-reduces the per-channel sums of ``dy`` and
    ``dy * x_hat``, so the input gradient is that of the sum of every rank's
    loss; the scale and bias gradients are this rank's rows' share, which
    :func:`sync_gradients` averages over 'data' as every other gradient (the
    global loss is the mean of the ranks' losses)."""
    return _BatchNorm.apply(x, weight, bias, eps, group)


def copy_to_model(x, group):
    """Identity forward; backward: all-reduce (sum) of the gradient over ``group``."""
    return _CopyToModel.apply(x, group)


def gather_from_model(x, group):
    """All-gather along channels (dim 1) forward; backward: this rank's slice."""
    return _GatherFromModel.apply(x, group)


def _flat_sum(tensors, group, keep=True):
    """Sum each dtype's ``tensors`` over ``group`` as one flat buffer, in place;
    ``keep=False`` sends zeros (the sum is then the other ranks')."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if not keep:
            flat.zero_()
        flat = all_reduce_sum(flat, group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def sync_gradients(mesh, modules):
    """After the accumulation loop: every gradient averaged over 'data' (one flat
    bucket per dtype, summed, divided by the axis size: the gradient of the mean
    of the ranks' losses, the whole batch's loss, also where a batch norm over
    'data' gave each rank's backward the other ranks' terms), and the gradients of
    the parameters that 'model' does not split taken from the axis's first rank
    (they are equal there up to the arithmetic of replicated work; a sum with
    the other ranks' zeros keeps the replicas bit-equal). Parameters without a
    gradient (frozen views) are the same on every rank and skipped."""
    params = [p for m in modules for p in m.parameters() if p.grad is not None]
    if 'data' in mesh.shape:
        grads = [p.grad for p in params]
        _flat_sum(grads, mesh.groups['data'])
        for g in grads:
            g.div_(mesh.axis_size('data'))
    if 'model' in mesh.shape:
        _flat_sum([p.grad for p in params if not is_split(p)], mesh.groups['model'],
                  keep=mesh.axis_index('model') == 0)


def data_mean(x, mesh):
    """The mean of ``x`` over 'data' (``x`` itself without that axis)."""
    if 'data' not in mesh.shape:
        return x
    return all_reduce_sum(x, mesh.groups['data']) / mesh.axis_size('data')


def data_gather(x, mesh, dim=0):
    """The ranks' ``x`` along 'data', concatenated along ``dim`` in rank order."""
    if 'data' not in mesh.shape:
        return x
    return all_gather(x, mesh.groups['data'], dim)


def model_gather(x, mesh, dim):
    """The ranks' ``x`` along 'model', concatenated along ``dim`` (no autograd)."""
    return all_gather(x, mesh.groups['model'], dim)
