"""Device mesh and sharding rules (torch port of
``acquisition_focus_tpu/parallel/mesh.py``).

One process per device, joined by ``torch.distributed``: NCCL on the card, one
GPU per rank; gloo on the CPU. The mesh's axes are the JAX package's:

* ``data``  -- the batch (and every grad-accum microbatch) is split over it;
  each rank computes its rows, and the gradients are averaged over the axis
  after the accumulation loop (``collectives.sync_gradients``).
* ``model`` -- feature tensor parallelism of the reconstruction model (the
  hybrid U-Net or (E)Pix2Vox): every parameter whose output-feature axis is > 1
  and divisible by the axis size is split along it (``feature_split_dims``;
  ``feature_parallel.py`` holds the modules that compute on such a split). The
  ATMs stay replicated.

Where the JAX package gives the shardings to XLA's SPMD partitioner, the port
places the collectives itself (``collectives.py``, ``PARITY.md``). The rank
layout is JAX's device array: rank = data index * model size + model index.
"""

import dataclasses
import math
import os
import socket

import torch
import torch.distributed as dist
import torch.nn as nn

AXES = ('data', 'model')
SPLIT_ATTR = 'model_split_dim'   # set on every parameter 'model' splits: its split axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: ``shape`` {axis: size} in the config's order,
    the torch ``DeviceMesh``, this rank's coordinate on each axis, each axis's
    process group, and the device the rank computes on."""
    shape: dict
    device_mesh: object
    coords: dict
    groups: dict
    device: torch.device

    @property
    def size(self):
        return math.prod(self.shape.values())

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def axis_index(self, axis):
        return self.coords.get(axis, 0)


def mesh_processes(mesh_shape):
    """The number of processes ``mesh_shape`` needs (1 for none)."""
    return math.prod(int(v) for v in mesh_shape.values()) if mesh_shape else 1


def is_split(p):
    """Whether the 'model' axis splits parameter ``p`` (``shard_params``)."""
    return hasattr(p, SPLIT_ATTR)


def is_main_process():
    """Rank 0 of the process group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(mesh_shape=None, devices=None):
    """mesh_shape: dict axis -> size, e.g. {'data': 2, 'model': 2}; falsy -> None.

    Needs an initialized process group of exactly as many processes as the mesh
    has devices (the CLI starts them: ``main.py``); under NCCL each rank takes
    its own GPU. ``devices``: one torch device per rank (default: the CPU under
    gloo, ``cuda:LOCAL_RANK`` under NCCL). Raises where fewer (or more)
    processes or GPUs exist than the mesh needs: it never runs on fewer."""
    if not mesh_shape:
        return None
    from torch.distributed.device_mesh import init_device_mesh
    unknown = [k for k in mesh_shape if k not in AXES]
    if unknown:
        raise ValueError(f"mesh axes {unknown}: expected a subset of {AXES}")
    shape = {k: int(v) for k, v in mesh_shape.items()}
    n = mesh_processes(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh {shape} needs {n} processes, one per device, and no process group "
            "exists: run through `python -m acquisition_focus_tpu_torch.main` (which "
            "starts them), under torchrun, or after torch.distributed.init_process_group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise RuntimeError(f"mesh {shape} needs {n} processes; the process group has "
                           f"{world}")
    if devices is not None:
        if len(devices) < n:
            raise RuntimeError(f"mesh {shape} needs {n} devices, got {len(devices)}")
        device = torch.device(devices[rank])
    elif dist.get_backend() == 'nccl':
        local = int(os.environ.get('LOCAL_RANK', rank))
        if torch.cuda.device_count() <= local:
            raise RuntimeError(f"mesh {shape} needs {n} GPUs on this host; "
                               f"{torch.cuda.device_count()} exist")
        device = torch.device('cuda', local)
    else:
        device = torch.device('cpu')
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    names = tuple(shape)
    dm = init_device_mesh(device.type, tuple(shape.values()), mesh_dim_names=names)
    return Mesh(shape=shape, device_mesh=dm,
                coords=dict(zip(names, dm.get_coordinate())),
                groups={k: dm.get_group(k) for k in names}, device=device)


def batch_shardings(mesh, train=True):
    """The split axis of each batch key (the JAX package's PartitionSpecs, with
    the index of the 'data' entry in place of each spec; None: replicated).
    Train batches carry (accum, B, ...), view affines and cached thetas
    (accum, V|A, B, ...); evaluation batches (B, ...) and (V|A, B, ...). On a
    model-only mesh every batch is replicated."""
    if mesh is None:
        return None
    on = 'data' in mesh.shape
    lead = 1 if train else 0
    return {
        'label': lead if on else None,
        'image': lead if on else None,
        'nii_affine': lead if on else None,
        'view_affines': lead + 1 if on else None,
        'thetas': lead + 1 if on else None,
    }


def shard_batch(batch, mesh, train=True):
    """This rank's slice of a batch (numpy arrays or tensors) along each key's
    split axis."""
    if mesh is None:
        return batch
    specs = batch_shardings(mesh, train)
    d, i = mesh.axis_size('data'), mesh.axis_index('data')
    out = {}
    for k, v in batch.items():
        axis = specs[k]
        if axis is None:
            out[k] = v
            continue
        n = v.shape[axis] // d
        out[k] = v[(slice(None),) * axis + (slice(i * n, (i + 1) * n),)]
    return out


def _tensors(tree):
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _tensors(x)]


def replicate(tree, mesh):
    """Make the tensors of ``tree`` (a module, a tensor or a list of them) equal on
    every rank: broadcast in place from rank 0. Returns ``tree``."""
    if mesh is None:
        return tree
    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t.data, src=0)
    return tree


def check_replicated(tree, mesh):
    """True where every tensor of ``tree`` is bit-equal to rank 0's on every rank."""
    same = True
    with torch.no_grad():
        for t in _tensors(tree):
            ref = t.detach().clone()
            dist.broadcast(ref, src=0)
            same &= bool(torch.equal(ref, t.detach()))
    flag = torch.tensor([0.0 if same else 1.0], device=mesh.device)
    dist.all_reduce(flag)
    return float(flag) == 0.0


def barrier(mesh):
    """Wait for every rank: a one-element all-reduce on the mesh's device, read
    back on the host (so the host waits too, under NCCL)."""
    if mesh is not None:
        t = torch.zeros(1, device=mesh.device)
        dist.all_reduce(t)
        t.item()


def broadcast_scalar(x, mesh):
    """Rank 0's value of a Python float on every rank: decisions taken on a
    number (best-checkpoint saves) must not part the ranks."""
    if mesh is None:
        return x
    t = torch.tensor([x], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, src=0)
    return float(t)


# ------------------------------------------------------------- the feature rule

def _output_feature_dim(module, pname):
    """The torch axis that holds flax's last (output-feature) axis: 1 for a
    ConvTranspose weight, (Ci, Co, k...) in torch and (k..., Ci, Co) in flax; 0
    for every other conv weight, bias and norm scale."""
    return 1 if isinstance(module, nn.modules.conv._ConvTransposeNd) \
        and pname == 'weight' else 0


def feature_split_dims(unet, model_size):
    """{parameter name: split axis} of the reconstruction model's parameters (the
    hybrid U-Net's or (E)Pix2Vox's) that a 'model' axis of
    ``model_size`` splits: the JAX package's ``_feature_shard_leaf`` (output-feature
    axis > 1 and divisible by the axis size) on each parameter's output-feature
    axis."""
    split = {}
    for mname, module in unet.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            dim = _output_feature_dim(module, pname)
            if p.ndim >= 1 and p.shape[dim] > 1 and p.shape[dim] % model_size == 0:
                split[f'{mname}.{pname}' if mname else pname] = dim
    return split


def shard_params(unet, atms, mesh):
    """Feature tensor parallelism of the reconstruction net over 'model': the
    parameters that ``feature_split_dims`` selects keep this rank's slice (in
    place: the optimizers keep their parameter objects) and the modules that own
    them compute on it (``feature_parallel.shard_model``: the hybrid U-Net's
    stages, or (E)Pix2Vox's conv and norm pairs, whose batch norms also take the
    whole batch's statistics over 'data'). The ATMs, and the whole model without
    a 'model' axis, stay replicated (made equal from rank 0). Returns {name:
    split axis} of the sliced parameters."""
    if mesh is None:
        return {}
    from acquisition_focus_tpu_torch.parallel.feature_parallel import shard_model
    replicate(atms, mesh)
    replicate(unet, mesh)
    split = feature_split_dims(unet, mesh.axis_size('model')) \
        if 'model' in mesh.shape else {}
    shard_model(unet, split, mesh)
    return split


def slice_tensor(t, dim, mesh):
    """This rank's slice along ``dim`` of a full tensor split over 'model'."""
    n = t.shape[dim] // mesh.axis_size('model')
    return t.narrow(dim, mesh.axis_index('model') * n, n).clone()


def shard_opt_state(opt, module, split, mesh):
    """Slice an optimizer's state of ``module``'s split parameters as the
    parameters are, in every param group: Adam's and AdamW's
    ``exp_avg``/``exp_avg_sq`` mirror the parameter shapes (the step counts stay). A state already at the slice's shape (or none:
    no step taken) is left. Returns ``opt``."""
    if mesh is None or not split:
        return opt
    names = {id(p): n for n, p in module.named_parameters()}
    for group in opt.param_groups:
        for p in group['params']:
            dim = split.get(names.get(id(p)))
            state = opt.state.get(p)
            if dim is None or not state:
                continue
            for k in ('exp_avg', 'exp_avg_sq'):
                if k in state and state[k].shape != p.shape:
                    state[k] = slice_tensor(state[k], dim, mesh)
    return opt


def slice_state_dict(state_dict, split, mesh):
    """A full state_dict -> this rank's: each split entry sliced along its axis."""
    return {k: slice_tensor(v, split[k], mesh) if k in split else v
            for k, v in state_dict.items()}


# ------------------------------------------------------------- process launch

def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, nprocs, port, backend, threads, args):
    if threads:
        torch.set_num_threads(threads)
    if backend == 'nccl':
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f'tcp://localhost:{port}', rank=rank,
                            world_size=nprocs)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, nprocs, args=(), backend='gloo', threads=None, join=True):
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes joined in one process
    group on a free localhost port (``backend`` 'nccl': rank r on ``cuda:r``;
    'gloo': the CPU, ``threads`` intra-op threads each). Returns when every rank
    has returned; raises if one failed (the others are stopped). ``join=False``
    returns at once with the processes' context: ``join_ranks`` waits for it."""
    return torch.multiprocessing.spawn(
        _rank_entry, args=(fn, nprocs, free_port(), backend, threads, tuple(args)),
        nprocs=nprocs, join=join)


def join_ranks(context):
    """Wait for the ranks of ``spawn_ranks(..., join=False)``; raises as it does."""
    while not context.join():
        pass


def mesh_summary(mesh):
    """A one-line description of the mesh for logs."""
    return (f"mesh {mesh.shape} ({mesh.size} processes, {dist.get_backend()}), rank "
            f"{dist.get_rank()} at {mesh.coords} on {mesh.device}")


__all__ = ['AXES', 'Mesh', 'SPLIT_ATTR', 'barrier', 'batch_shardings', 'broadcast_scalar',
           'check_replicated', 'feature_split_dims', 'free_port', 'is_main_process',
           'is_split', 'join_ranks', 'make_mesh', 'mesh_processes', 'mesh_summary',
           'replicate', 'shard_batch', 'shard_opt_state', 'shard_params',
           'slice_state_dict', 'slice_tensor', 'spawn_ranks']
