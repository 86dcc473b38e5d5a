"""Rank functions of ``test_torch_mesh.py``, ``test_torch_epix2vox_mesh*.py`` and
``test_torch_p2v_kernels.py``, in a module that imports no JAX: each rank that
``parallel.spawn_ranks`` starts imports this module to find them.

A rank runs a list of jobs ``(function name, *args)`` in order; rank 0 saves each
job's result to ``out_dir/<i>.pt`` (every job is a collective, so rank 0's
gathered result is the mesh's)."""

import time
from pathlib import Path

import numpy as np
import torch

import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.convert import load_flax_params_sharded
from acquisition_focus_tpu_torch.engine.checkpoint import (
    gather_module_state, gather_optimizer_state, load_optimizer)
from acquisition_focus_tpu_torch.engine.optimizers import (
    make_epix2vox_optimizer, make_reconstruction_optimizer, make_transform_optimizer)
from acquisition_focus_tpu_torch.engine.runner import run_dl
from acquisition_focus_tpu_torch.models.epix2vox import (
    BatchNorm, Bottleneck, Epix2VoxDecoder, Epix2VoxMerger)
from acquisition_focus_tpu_torch.parallel.collectives import (
    all_gather, all_reduce_sum, copy_to_model, data_gather, gather_from_model, model_gather)
from acquisition_focus_tpu_torch.models import recompute
from acquisition_focus_tpu_torch.ops.kernels import p2v_tail
from acquisition_focus_tpu_torch.parallel.feature_parallel import shard_epix2vox
from acquisition_focus_tpu_torch.parallel.mesh import SPLIT_ATTR, is_split
from acquisition_focus_tpu_torch.parallel.mesh import (
    check_replicated, feature_split_dims, make_mesh, shard_batch, shard_params)
from acquisition_focus_tpu_torch.scripts.smoke_mesh import Branches
from acquisition_focus_tpu_torch.utils import spans

LR, UPE, EPOCHS = 1e-3, 2, 8


def models(spec_kw, decoder=None):
    """The port's models on the CPU; under an (E)Pix2Vox ``model_type``,
    ``decoder`` narrows its decoder to those ``features`` (fewer levels: a
    coarser output volume, which the spec's hires grid must match)."""
    spec = ttrain.StageSpec(**spec_kw)
    unet, atms = ttrain.make_models(spec, 'cpu')
    if decoder is not None:
        unet.decoder = Epix2VoxDecoder(features=decoder)
    return spec, unet, atms


def build(spec_kw, unet_sd, atm_sds, decoder=None):
    """The port's models on the CPU from full state_dicts, and both optimizers
    (the reconstruction one (E)Pix2Vox's Adam under its ``model_type``)."""
    spec, unet, atms = models(spec_kw, decoder)
    unet.load_state_dict(unet_sd)
    for m, sd in zip(atms, atm_sds):
        m.load_state_dict(sd)
    if spec.model_type in ttrain.EPIX2VOX_TYPES:
        r_opt = make_epix2vox_optimizer(unet, UPE)
    else:
        r_opt = make_reconstruction_optimizer(unet.parameters(), LR, UPE)
    t_opt = make_transform_optimizer(atms.parameters(), LR, EPOCHS, UPE)
    return spec, unet, atms, r_opt, t_opt


def step(spec_kw, batch, unet_sd, atm_sds, seed, mesh_shape=None, branches=None,
         decoder=None, dtype=None):
    """One ``train_step`` (on ``mesh_shape``, or in this process alone): loss,
    dice, every gradient and updated parameter as full tensors, the split
    parameters' names, whether the replicated state is bit-equal on every rank;
    and the LeakyReLU inputs (one process) or, given the one-process
    ``branches``, the mesh's run with those branches imposed: how many elements
    had the other sign, and the largest input difference (``Branches``).
    ``decoder``: see :func:`models`. ``dtype``: the reconstruction model's
    parameters cast to it (an (E)Pix2Vox model computes in its parameters' dtype)."""
    mesh = make_mesh(mesh_shape)
    spec, unet, atms, r_opt, t_opt = build(spec_kw, unet_sd, atm_sds, decoder)
    if dtype is not None:
        unet.to(dtype)
    split = shard_params(unet, atms, mesh)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    tb = shard_batch(tb, mesh, True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    with Branches(branches, mesh) as acts:
        metrics = ttrain.train_step(spec, unet, atms, r_opt, t_opt, tb, gen, mesh=mesh)

    grads = {}
    for prefix, module in (('unet.', unet), ('atms.', atms)):
        for name, p in module.named_parameters():
            if p.grad is None:
                continue
            g = p.grad
            if mesh is not None and is_split(p):
                g = model_gather(g, mesh, getattr(p, SPLIT_ATTR))
            grads[prefix + name] = g.clone()
    params = {f'unet.{k}': v.clone() for k, v in
              gather_module_state(unet, split, mesh).items()}
    params.update({f'atms.{k}': v.clone() for k, v in atms.state_dict().items()})
    out = dict(loss=metrics['loss'].clone(), dice=metrics['dice'].clone(), grads=grads,
               params=params, split=sorted(split))
    opt = gather_optimizer_state(r_opt[0], unet, split, mesh)
    out['moment_shapes'] = {i: tuple(s['exp_avg'].shape) for i, s in opt['state'].items()}
    if mesh is None:
        out['branches'] = acts.records
    else:
        replicated = list(atms.parameters()) + [p for p in unet.parameters()
                                                 if not is_split(p)]
        out['replicas_equal'] = check_replicated(replicated, mesh)
        if branches is not None:
            flips = torch.tensor([float(acts.flips)], device=mesh.device)
            diff = torch.tensor([acts.max_diff], device=mesh.device)
            dist.all_reduce(flips)
            dist.all_reduce(diff, op=dist.ReduceOp.MAX)
            out['branch_flips'], out['act_max_diff'] = int(flips), float(diff)
    return out


def epix2vox_init(spec_kw, decoder=None):
    """An (E)Pix2Vox model's and its ATMs' state_dicts from ``init_params`` (seed 0)."""
    _, unet, atms = models(spec_kw, decoder)
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(0))
    return unet.state_dict(), [m.state_dict() for m in atms]


def batch_norm(x, weight, bias, cotangent, data):
    """An (E)Pix2Vox ``BatchNorm`` on {'data': ``data``}: each rank normalizes its
    rows of ``x`` (N, C, ...) and takes the gradient of sum(y * cotangent) over
    them. Returns the whole batch's output and input gradient (gathered) and the
    scale and bias gradients summed over the ranks."""
    mesh = make_mesh({'data': data})
    norm = BatchNorm(x.shape[1])
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    norm.group = mesh.groups['data']
    rows = shard_batch({'label': x, 'image': cotangent}, mesh, train=False)
    xr = rows['label'].clone().requires_grad_()
    y = norm(xr)
    (y * rows['image']).sum().backward()
    group = mesh.groups['data']
    return dict(y=data_gather(y.detach(), mesh), dx=data_gather(xr.grad, mesh),
                dweight=all_reduce_sum(norm.weight.grad, group),
                dbias=all_reduce_sum(norm.bias.grad, group))


def merger_data_group(state_dict, slope, x, cotangent, data, device):
    """The (E)Pix2Vox merger's blocks through ``p2v_tail.merge_convs`` (the plain
    versions for CPU tensors, the kernels for CUDA ones: ``device``, which every
    rank shares) on {'data': ``data``}: each rank takes its rows of x (N, 9,
    ...), its norms' statistics over the whole batch, and the gradient of
    sum(out * cotangent) over its rows. Returns the whole batch's output and input
    gradient (gathered) and each parameter's gradient summed over the ranks."""
    mesh = make_mesh({'data': data})
    group, k = mesh.groups['data'], x.shape[0] // data
    rows = slice(mesh.axis_index('data') * k, (mesh.axis_index('data') + 1) * k)
    merger = Epix2VoxMerger(slope).to(device=device, dtype=x.dtype)
    merger.load_state_dict(state_dict)
    n = len(merger.FEATURES)
    norms = [getattr(merger, f'm{i}_bn') for i in range(n)]
    for norm in norms:
        norm.group = group
    xr = x[rows].clone().to(device).requires_grad_()
    out = p2v_tail.merge_convs(xr, [getattr(merger, f'm{i}_conv') for i in range(n)], norms,
                               slope)
    (out * cotangent[rows].to(device)).sum().backward()
    return dict(out=data_gather(out.detach().cpu(), mesh), dx=data_gather(xr.grad.cpu(), mesh),
                grads={name: all_reduce_sum(p.grad.cpu(), group)
                       for name, p in merger.named_parameters()})


def bottleneck(state_dict, args, x, cotangent, model):
    """A ``Bottleneck(*args)`` split over {'model': ``model``}
    (``feature_parallel.shard_epix2vox``) on the replicated ``x``: its output, input
    gradient and parameter gradients (gathered to full tensors) for the
    cotangent, and the names of the split parameters."""
    mesh = make_mesh({'model': model})
    block = Bottleneck(*args)
    block.load_state_dict(state_dict)
    split = feature_split_dims(block, model)
    shard_epix2vox(block, split, mesh)
    xr = x.clone().requires_grad_()
    y = block(xr)
    (y * cotangent).sum().backward()
    grads = {n: model_gather(p.grad, mesh, getattr(p, SPLIT_ATTR)) if is_split(p)
             else p.grad for n, p in block.named_parameters()}
    return dict(y=y.detach(), dx=xr.grad, grads=grads, split=sorted(split))


def channel_gathers(n):
    """The gathers of the 'model' split on {'model': ``n``} (``mesh.device``: the
    CPU under gloo, ``cuda:<rank>`` under NCCL): ``gather_from_model`` of each
    rank's (2, 3, 4, 5, 6) slab, contiguous and channels-last, against
    ``torch.cat`` of every rank's slab (each rank draws them all from one seed),
    its layout, and its backward (this rank's slice of the cotangent);
    ``all_gather`` along the batch; ``copy_to_model`` of a channels-last batch
    of one: its strides, and its backward (the sum over the ranks). Returns the
    mismatches summed over the ranks and rank 0's names of them."""
    mesh = make_mesh({'model': n})
    group, r, dev = mesh.groups['model'], mesh.axis_index('model'), mesh.device
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(2, 3, 4, 5, 6, generator=gen) for _ in range(n)]
    bad = []
    if not torch.equal(all_gather(parts[r].to(dev), group, 0).cpu(), torch.cat(parts, 0)):
        bad.append('all_gather along the batch')
    whole = torch.cat(parts, dim=1)
    cotangent = torch.arange(whole.numel(), dtype=whole.dtype).view_as(whole)
    for layout in (torch.contiguous_format, torch.channels_last_3d):
        x = parts[r].to(dev).clone(memory_format=layout).requires_grad_()
        y = gather_from_model(x, group)
        if not torch.equal(y.detach().cpu(), whole):
            bad.append(f'{layout}: values')
        if not y.is_contiguous(memory_format=layout):
            bad.append(f'{layout}: layout {y.stride()}')
        (y * cotangent.to(dev)).sum().backward()
        if not torch.equal(x.grad.cpu(), cotangent.chunk(n, dim=1)[r]):
            bad.append(f'{layout}: gradient')
    x = parts[r][:1].to(dev).clone(memory_format=torch.channels_last_3d).requires_grad_()
    y = copy_to_model(x, group)
    if y.stride() != x.stride():
        bad.append(f'copy_to_model: strides {y.stride()} of {x.stride()}')
    (y * (r + 1)).sum().backward()
    if not torch.equal(x.grad.cpu(), torch.full(x.shape, n * (n + 1) / 2)):
        bad.append('copy_to_model: gradient')
    count = torch.tensor([len(bad)], device=dev)
    dist.all_reduce(count)
    return dict(mismatches=int(count), rank0=bad)


class _Dispatched(TorchDispatchMode):
    """The names of the dispatcher ops run while active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _gathered_square(x, scale, group):
    return gather_from_model(x * scale, group).square()


def replayed_gather(group, shape=(2, 4)):
    """A recompute region that keeps its all-gather (``recompute.COLLECTIVES``)
    and squares what it gathered (so backward replays it for the square's
    input), forward and backward: the counters after each, the dispatcher ops of
    the backward, and whether the input's gradient is this rank's slice's."""
    scale = float(dist.get_rank(group) + 1)
    x = torch.ones(shape, requires_grad=True)
    spans.reset('recompute.served')
    out = recompute.region(_gathered_square, x, scale, group,
                           save_ops=recompute.COLLECTIVES)
    after_forward = spans.totals()
    with _Dispatched() as seen:
        out.sum().backward()
    return dict(after_forward=after_forward, after_backward=spans.totals(),
                backward_ops=seen.ops,
                grad_ok=torch.equal(x.grad, torch.full(shape, 2 * scale * scale)))


def replayed_gather_on(mesh_shape):
    """:func:`replayed_gather` over the 'model' axis of ``mesh_shape``."""
    return replayed_gather(make_mesh(mesh_shape).groups['model'])


def collective_counts(spec_kw, batch, seed):
    """The collective counters (``collective.calls``, ``collective.bytes``) on a
    {'data': n} mesh: after one all-reduce of 3 float32 values, one all-gather of
    8, and a recompute region's all-gather of 8 kept for its replay (counted in
    the forward, not in the replay), and in one ``train_step`` with spans on,
    beside the bytes that step's collectives move (every gradient in one flat
    bucket, the loss's mean, the dice's gather) and its span records as (name,
    parent, step id)."""
    mesh = make_mesh({'data': dist.get_world_size()})
    group = mesh.groups['data']
    spans.reset('collective.')
    all_reduce_sum(torch.ones(3), group)
    after_reduce = spans.totals()
    all_gather(torch.ones(2, 4), group, 0)
    after_gather = spans.totals()
    kept = replayed_gather(group)
    spec = ttrain.StageSpec(**spec_kw)
    unet, atms = ttrain.make_models(spec, 'cpu')
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(seed))
    r_opt = make_reconstruction_optimizer(unet.parameters(), LR, UPE)
    t_opt = make_transform_optimizer(atms.parameters(), LR, EPOCHS, UPE)
    tb = shard_batch({k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}, mesh)
    spans.clear_records()
    spans.enable()
    try:
        out = ttrain.train_step(spec, unet, atms, r_opt, t_opt, tb, mesh=mesh)
    finally:
        spans.enable(False)
    step = spans.recent_steps(1)[0]
    grads = sum(p.grad.numel() * p.grad.element_size()
                for m in (unet, atms) for p in m.parameters() if p.grad is not None)
    local_dice = out['dice'].numel() // mesh.axis_size('data')
    return dict(after_reduce=after_reduce, after_gather=after_gather, kept=kept,
                step=step.counts,
                expected_bytes=grads + 4 + local_dice * out['dice'].element_size(),
                records=[(r.name, r.parent, r.step) for r in spans.records()],
                step_id=step.step)


def weights_across(spec_kw, unet_params, atm_params, moments, mesh_shape):
    """The JAX package's full params (flax trees of numpy arrays) and full Adam
    moments (the orbax import's ``{'moments': ...}`` form) loaded straight into a
    split model and its optimizer, then gathered back to full tensors."""
    mesh = make_mesh(mesh_shape)
    unet, atms = ttrain.make_models(ttrain.StageSpec(**spec_kw), 'cpu')
    split = shard_params(unet, atms, mesh)
    load_flax_params_sharded(unet, atms, unet_params, atm_params, split, mesh)
    opt, sched = make_reconstruction_optimizer(unet.parameters(), LR, UPE)
    load_optimizer(opt, sched, unet, {'moments': moments}, {'last_epoch': 3}, split, mesh)
    return dict(params=gather_module_state(unet, split, mesh), split=sorted(split),
                opt=gather_optimizer_state(opt, unet, split, mesh),
                names=[n for n, _ in unet.named_parameters()])


def run(base_dir, config, fold, datasets, run_name):
    """``run_dl`` on the CPU (the mesh from ``config``); returns its save path."""
    train_ds, test_ds = datasets
    return run_dl(base_dir, config, fold, training_dataset=train_ds, test_dataset=test_ds,
                  run_name=run_name, device='cpu')


def cli(argv):
    """The CLI in a process group that already exists (as under torchrun): every
    rank joins it, rank 0 builds the datasets and sends them."""
    from acquisition_focus_tpu_torch import main as tmain
    tmain.main(argv, device='cpu')


def mesh_error(mesh_shape):
    """The error ``make_mesh`` raises for ``mesh_shape`` in this group, or None."""
    try:
        make_mesh(mesh_shape)
    except RuntimeError as e:
        return str(e)
    return None


def wait_for(path, seconds=600):
    """Wait until ``path`` exists (a file the test's own process writes)."""
    deadline = time.time() + seconds
    while not Path(path).exists():
        if time.time() > deadline:
            raise TimeoutError(f"{path} did not appear in {seconds} s")
        time.sleep(0.1)


def world(rank, jobs, out_dir):
    Path(out_dir).mkdir(exist_ok=True)
    for i, (name, *args) in enumerate(jobs):
        result = globals()[name](*args)
        if rank == 0:
            torch.save(result, Path(out_dir) / f'{i}.pt')
