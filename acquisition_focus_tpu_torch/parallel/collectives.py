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
over 'data' is :func:`sync_gradients` after the accumulation loop.

Every collective is a functional collective (``torch.ops._c10d_functional``,
with ``wait_tensor``): dispatcher ops, so the recompute policy of
``models/recompute.py`` sees the forward all-gathers and keeps their outputs
(:data:`KEPT_OPS`) instead of running them a second time in backward.
"""

import torch
import torch.distributed as dist

from acquisition_focus_tpu_torch.parallel.mesh import is_split

_c10d = torch.ops._c10d_functional

# the forward collectives' ops, whose outputs a recompute region keeps
KEPT_OPS = frozenset({_c10d.all_gather_into_tensor.default, _c10d.wait_tensor.default})


def all_reduce_sum(x, group):
    """The sum of ``x`` over ``group`` (a new tensor)."""
    return _c10d.wait_tensor(_c10d.all_reduce(x.contiguous(), 'sum', group.group_name))


def all_gather(x, group, dim):
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in rank order."""
    n = group.size()
    g = _c10d.wait_tensor(_c10d.all_gather_into_tensor(x.contiguous(), n,
                                                       group.group_name))
    if dim == 0:
        return g
    g = g.view((n,) + tuple(x.shape)).movedim(0, dim)
    return g.reshape(x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

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
    bucket per dtype, summed, divided by the axis size), and the gradients of
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
