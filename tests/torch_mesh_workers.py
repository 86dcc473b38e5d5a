"""Rank functions of ``test_torch_mesh.py``, in a module that imports no JAX: each
rank that ``parallel.spawn_ranks`` starts imports this module to find them.

A rank runs a list of jobs ``(function name, *args)`` in order; rank 0 saves each
job's result to ``out_dir/<i>.pt`` (every job is a collective, so rank 0's
gathered result is the mesh's)."""

import time
from pathlib import Path

import numpy as np
import torch

import torch.distributed as dist

from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.convert import load_flax_params_sharded
from acquisition_focus_tpu_torch.engine.checkpoint import (
    gather_module_state, gather_optimizer_state, load_optimizer)
from acquisition_focus_tpu_torch.engine.optimizers import (
    make_reconstruction_optimizer, make_transform_optimizer)
from acquisition_focus_tpu_torch.engine.runner import run_dl
from acquisition_focus_tpu_torch.parallel.collectives import model_gather
from acquisition_focus_tpu_torch.parallel.mesh import SPLIT_ATTR, is_split
from acquisition_focus_tpu_torch.parallel.mesh import (
    check_replicated, make_mesh, shard_batch, shard_params)
from acquisition_focus_tpu_torch.scripts.smoke_mesh import Branches

LR, UPE, EPOCHS = 1e-3, 2, 8


def build(spec_kw, unet_sd, atm_sds):
    """The port's models on the CPU from full state_dicts, and both optimizers."""
    spec = ttrain.StageSpec(**spec_kw)
    unet, atms = ttrain.make_models(spec, 'cpu')
    unet.load_state_dict(unet_sd)
    for m, sd in zip(atms, atm_sds):
        m.load_state_dict(sd)
    r_opt = make_reconstruction_optimizer(unet.parameters(), LR, UPE)
    t_opt = make_transform_optimizer(atms.parameters(), LR, EPOCHS, UPE)
    return spec, unet, atms, r_opt, t_opt


def step(spec_kw, batch, unet_sd, atm_sds, seed, mesh_shape=None, branches=None):
    """One ``train_step`` (on ``mesh_shape``, or in this process alone): loss,
    dice, every gradient and updated parameter as full tensors, the split
    parameters' names, whether the replicated state is bit-equal on every rank;
    and the LeakyReLU inputs (one process) or, given the one-process
    ``branches``, the mesh's run with those branches imposed: how many elements
    had the other sign, and the largest input difference (``Branches``)."""
    mesh = make_mesh(mesh_shape)
    spec, unet, atms, r_opt, t_opt = build(spec_kw, unet_sd, atm_sds)
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
