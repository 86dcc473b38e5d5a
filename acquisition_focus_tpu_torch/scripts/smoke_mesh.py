"""Drive the port's device mesh on several H100s (NCCL, one process per GPU).

    python3 -m acquisition_focus_tpu_torch.scripts.smoke_mesh [--device cpu]
        [--cases unet,epix2vox]

Needs 4 GPUs (``--device cpu``: a rehearsal in gloo processes at a small size,
without the kernel checks). Run from the repository root: it takes its kernel
checks and step helpers from ``chip_smoke.py``.

1. The card's name and power limit, the interconnect (``nvidia-smi topo -m``); the
   kernels built once, before any rank starts.
2. K3 (forward and as the input gradient) and K4 at the shapes a 'model' axis
   gives the 128^3 decoder convs (Ci 96 / 48 -> Co 24 at m = 2, -> 12 at m = 4)
   against their plain versions, timed with their bounds and library calls
   (``chip_smoke.py``'s checks, rows '<kernel> mesh').
3. The default step (``spec_from_config(DEFAULTS, 6, 3)``: full width, 128^3,
   batch 2 x accum 2, bf16) under ``'fwd'`` and ``'full'`` on one GPU, then on
   {'data': 2}, {'model': 2}, {'data': 2, 'model': 2} and {'model': 4}, from the
   same weights, batch and augmentation draws: the first microbatch's gradients,
   gathered to full, within MESH_GRAD_TOL of each leaf's max of the one-GPU
   step's in the mesh's own batch layout (a data axis of d: the mean of the
   batch's d row blocks' gradients, each block with its rows' draws: that layout
   alone moves the one-GPU gradients; the deviation between the layouts and each
   mesh's from the whole batch's are printed); step 0's loss within
   MESH_LOSS_TOL (rel.) of the whole batch's; per rank: s/step (3 synced steps
   after 1 warm-up), peak memory, launches per step. A small float32
   configuration (32^3, TF32 off) on each mesh, with the one-GPU LeakyReLU slopes
   imposed (``Branches``): its gradients within F32_GRAD_TOL of each leaf's max of
   one GPU's in the same layout.
4. A {'data': 2, 'model': 2} stage sweep through the CLI (``main.main``, which
   starts the four ranks) on 8 phantom cases written as NIfTI files at 128^3:
   2 epochs per stage, all four stages, read back as ``chip_smoke.py`` reads its
   sweep; the last stage's checkpoint then loads into a one-GPU ``run_dl``
   (test phase) and holds every tensor at its one-device shape.

5. (E)Pix2Vox and Pix2Vox (``--cases epix2vox``; ``check_epix2vox_meshes``):
   ``config_dict_id21.json``'s ref stage at 128^3, batch 2 x accum 2, TF32 off,
   on the four meshes against one GPU on the whole batch (a data mesh's batch
   norms take the whole batch's statistics): the first microbatch's gradients,
   with the model's parameters in float64 on both sides (``float64_grads``),
   within EPIX_GRAD_TOL of each leaf's max; in float32, step 0 loss within
   EPIX_LOSS_TOL (rel.), s/step and peak per rank. Then a {'data': 2} CLI run of
   id21 (2 epochs) whose checkpoint loads into a one-GPU ``run_dl``.

Sections 1-4 are ``--cases unet``. Any miss raises. The last line is one JSON
object with the numbers.
"""

import argparse
import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
MESHES = ({'data': 2}, {'model': 2}, {'data': 2, 'model': 2}, {'model': 4})
CONVS_MESH = ((96, 24), (48, 24), (96, 12), (48, 12))   # (Ci, Co / m) at 128^3
MESH = ' mesh'                 # suffix of the kernel rows at the shard shapes
MESH_GRAD_TOL = 2e-2           # chip_smoke.RECOMPUTE_GRAD_TOL: bf16, per leaf max
MESH_LOSS_TOL = 1e-3           # step 0 loss, relative, bf16
F32_GRAD_TOL = 1e-4            # float32, TF32 off, per leaf max
F32_ACT_TOL = 1e-3             # float32: max |activation input - one device's|
STEPS = 4                      # per mode and mesh, the first a warm-up
EPIX_TYPES = ('hybrid-EPix2Vox', 'hybrid-Pix2Vox')
# config_dict_id21.json's ref stage (2 views, binarized, fixed views), float32
EPIX = dict(base_views=['p2CH', 'p4CH'], use_binarized_labels=True,
            compute_dtype='float32', view_optimization_mode='opt-none',
            use_affine_theta=False)
EPIX_GRAD_TOL = 1e-4           # float64 model, per leaf max, against the whole batch
EPIX_LOSS_TOL = 1e-5           # step 0 loss, relative
SMALL = dict(hires_fov_mm=[48.0] * 3, hires_fov_vox=[32] * 3, prescan_fov_mm=[48.0] * 3,
             prescan_fov_vox=[32] * 3, slice_fov_mm=[48.0, 48.0, 1.5],
             slice_fov_vox=[32, 32, 1], compute_dtype='float32',
             base_features=[4, 8, 8, 16], locnet_width=4)


def log(*args):
    print(*args, flush=True)


def chip_smoke():
    """``chip_smoke.py`` from the repository root, imported as a module."""
    if 'chip_smoke' not in sys.modules:
        spec = importlib.util.spec_from_file_location('chip_smoke', REPO / 'chip_smoke.py')
        module = importlib.util.module_from_spec(spec)
        sys.modules['chip_smoke'] = module
        spec.loader.exec_module(module)
    return sys.modules['chip_smoke']


class Branches:
    """The LeakyReLU branch of every element of a step (the U-Net's and the
    localization nets' activations, in call order). The step's gradient jumps
    where an activation's input crosses 0, and a mesh rounds each input
    otherwise than one device (other summation orders), so an input within that
    rounding of 0 takes the other slope there and moves the gradients behind it
    far beyond the rounding. Without ``ref`` the inputs are recorded (on the
    host); with the one-device ``ref``, each rank takes the recorded slope for
    its rows and feature slice of each input, and ``flips`` counts the elements
    whose own sign differed, ``max_diff`` the largest |input - recorded|."""

    def __init__(self, ref=None, mesh=None):
        self.ref, self.mesh, self.records = ref, mesh, []
        self.flips, self.max_diff = 0, 0.0

    def __call__(self, x, negative_slope=0.01):
        if self.ref is None:
            self.records.append(x.detach().cpu())
            return torch.where(x >= 0, x, x * negative_slope)
        r = self.ref[len(self.records)]
        self.records.append(None)
        if x.shape[0] != r.shape[0]:
            r = r.narrow(0, self.mesh.axis_index('data') * x.shape[0], x.shape[0])
        if x.shape[1] != r.shape[1]:
            r = r.narrow(1, self.mesh.axis_index('model') * x.shape[1], x.shape[1])
        r = r.to(x.device)
        self.flips += int(((x >= 0) != (r >= 0)).sum())
        self.max_diff = max(self.max_diff, float((x.detach() - r).abs().max()))
        return torch.where(r >= 0, x, x * negative_slope)

    def __enter__(self):
        from acquisition_focus_tpu_torch.models import hybrid_unet, localization
        self.saved = hybrid_unet.leaky_relu, localization.leaky_relu
        hybrid_unet.leaky_relu = localization.leaky_relu = self
        return self

    def __exit__(self, *exc):
        from acquisition_focus_tpu_torch.models import hybrid_unet, localization
        hybrid_unet.leaky_relu, localization.leaky_relu = self.saved


def cases(device):
    """(name, config overrides, timed) of the steps each mesh runs."""
    if device == 'cpu':
        return (('f32', dict(SMALL), True),
                ('bf16', dict(SMALL, compute_dtype='bfloat16'), False))
    return (('fwd', dict(use_pallas_conv3d='fwd'), True),
            ('full', dict(use_pallas_conv3d='full'), True),
            ('f32', dict(SMALL), False))


def first_grads(spec, unet, atms, batch, mesh=None, blocks=1, branches=None):
    """The first microbatch's gradients as ``train_step`` forms them (loss / accum,
    augmentation seed 0), full tensors on the host; no update. On a ``mesh``:
    this rank's rows, averaged over 'data', the split leaves gathered. On one
    device with ``blocks`` = d > 1: the data axis's layout on one device, the
    mean of the d row blocks' gradients, each block with its rows' draws and,
    given the whole batch's ``branches``, its rows' LeakyReLU slopes imposed."""
    from acquisition_focus_tpu_torch.engine import train
    from acquisition_focus_tpu_torch.parallel.collectives import (
        model_gather, sync_gradients)
    from acquisition_focus_tpu_torch.parallel.mesh import SPLIT_ATTR, is_split
    from acquisition_focus_tpu_torch.parallel.mesh import Mesh, shard_batch
    micro = {k: v[0] for k, v in batch.items()}
    if mesh is not None:
        parts = [(micro, (mesh.axis_index('data'), mesh.axis_size('data'))
                  if 'data' in mesh.shape else None)]
    else:
        parts = [(shard_batch(micro, Mesh({'data': blocks}, None, {'data': i}, {}, None),
                              train=False), (i, blocks) if blocks > 1 else None)
                 for i in range(blocks)]
    for i, (part, shard) in enumerate(parts):
        with (Branches(branches, Mesh({'data': blocks}, None, {'data': i}, {}, None))
              if branches is not None else contextlib.nullcontext()):
            loss, _ = train.forward(spec, unet, atms, part,
                                    torch.Generator().manual_seed(0), data_shard=shard)
            (loss / spec.num_grad_accum_steps / len(parts)).backward()
    if mesh is not None:
        sync_gradients(mesh, (unet, atms))
    grads = {}
    for prefix, m in (('unet.', unet), ('atms.', atms)):
        for name, p in m.named_parameters():
            if p.grad is not None:
                g = p.grad
                if mesh is not None and is_split(p):
                    g = model_gather(g, mesh, getattr(p, SPLIT_ATTR))
                grads[prefix + name] = g.to(torch.promote_types(g.dtype, torch.float32)).cpu()
            p.grad = None
    return grads


class R6Norms:
    """Per view, the smallest norm over the batch of the R6 head's two 3-vectors
    (the localization net's output plus its init): a rotation from a short R6
    vector is ill-conditioned, so its gradient follows the input's rounding."""

    def __init__(self, atms):
        self.atms, self.norms = atms, {}

    def __enter__(self):
        def hook(v):
            def record(module, args, out):
                ap = out.detach().float()[:, :6] + out.new_tensor(
                    (1e-2, 0.0, 0.0, 0.0, 1e-2, 0.0)).float()
                low = min(float(ap[:, :3].norm(dim=1).min()),
                          float(ap[:, 3:].norm(dim=1).min()))
                self.norms[v] = min(self.norms.get(v, math.inf), low)
            return record
        self.handles = [a.locnet.register_forward_hook(hook(v))
                        for v, a in enumerate(self.atms)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def timed_steps(spec, unet, atms, recon, trans, batch, mesh):
    """STEPS train_steps from augmentation seed 0: step 0's loss, s/step (steps
    1.., each ending in a sync), the peak memory and the launches per step."""
    from acquisition_focus_tpu_torch.engine import train
    from acquisition_focus_tpu_torch.ops.kernels import _lib
    cuda = batch['label'].is_cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    gen = torch.Generator().manual_seed(0)
    times, losses = [], []
    for step in range(STEPS):
        t0 = time.perf_counter()
        loss = float(train.train_step(spec, unet, atms, recon, trans, batch, gen,
                                      mesh=mesh)['loss'])
        sync()
        if step:
            times.append(time.perf_counter() - t0)
        if not math.isfinite(loss):
            raise AssertionError(f"step {step}: loss {loss}")
        losses.append(loss)
    return {'loss0': losses[0], 's_step': sum(times) / len(times),
            'peak': torch.cuda.max_memory_allocated() if cuda else None,
            'launches_per_step': {k: v / STEPS for k, v in _lib.LAUNCHES.items() if v}}


def spec_for(overrides):
    """The stage spec of DEFAULTS with ``overrides``: 6 classes (2 under binarized
    labels), every base view active."""
    from acquisition_focus_tpu_torch.engine.runner import DEFAULTS, spec_from_config
    config = dict(DEFAULTS, **overrides)
    return spec_from_config(config, 2 if config['use_binarized_labels'] else 6,
                            len(config['base_views']))


def epix_batch(spec, device):
    """``chip_smoke.phantom_batch`` (batch 2) with the labels binarized and each
    view of each sample turned by 6-17 degrees about a random axis (seeded): cut
    along one plane, two views are equal, and Pix2Vox's merger then weighs them
    0.5 each whatever its parameters, which take an exactly zero gradient."""
    batch = chip_smoke().phantom_batch(spec, device)
    rng = np.random.default_rng(2)
    lead = tuple(batch['view_affines'].shape[:-2])
    turns = np.tile(np.eye(4), lead + (1, 1))
    for idx in np.ndindex(lead):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        angle = rng.uniform(0.1, 0.3)
        turns[idx][:3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    views = batch['view_affines'] @ torch.tensor(turns, dtype=torch.float32, device=device)
    return dict(batch, label=(batch['label'] > 0).long(), view_affines=views)


def float64_grads(spec, unet, atms, batch, mesh=None):
    """``first_grads`` with the (E)Pix2Vox model's parameters in float64 (it
    computes in its parameters' dtype; the slices before it stay float32), then
    back in float32: one device's float32 gradients stray from exact arithmetic
    by more than the bound a mesh is held to (``encoder.l4_bn.weight`` by half
    of itself, ``decoder.up2.weight`` by 5e-2 of its max: the batch norms'
    sums over 128^3 volumes cancel), where float64 leaves a mesh's other
    summation orders visible alone."""
    unet.double()
    grads = first_grads(spec, unet, atms, batch, mesh)
    unet.float()
    return grads


def run_case(name, overrides, timed, device, mesh=None, branches=None, blocks=(1,)):
    """One case on one GPU (``mesh`` None) or on this rank of a mesh:
    ({blocks: first-microbatch gradients}, step numbers or None, :class:`Branches`,
    {blocks: R6 norms}). On one GPU the gradients are taken in each layout of
    ``blocks`` (``first_grads``). The float32 case records its activations'
    branches on one GPU (whole batch) and imposes them on a mesh (``branches``:
    the one-GPU record)."""
    from acquisition_focus_tpu_torch.parallel.mesh import shard_batch, shard_params
    cs = chip_smoke()
    spec = spec_for(overrides)
    unet, atms, recon, trans = cs.build_step(spec, device)
    batch = (epix_batch if spec.model_type in EPIX_TYPES else cs.phantom_batch)(spec, device)
    acts = Branches(branches, mesh)
    grads, norms = {}, {}
    if mesh is not None:
        shard_params(unet, atms, mesh)
        batch = shard_batch(batch, mesh, True)
    for d in blocks if mesh is None else (None,):
        with R6Norms(atms) as r6:
            if name == 'f32' and d in (1, None):
                with acts:
                    grads[d] = first_grads(spec, unet, atms, batch, mesh, d or 1)
            else:
                grads[d] = first_grads(spec, unet, atms, batch, mesh, d or 1,
                                       acts.records if name == 'f32' else None)
        norms[d] = r6.norms
    steps = timed_steps(spec, unet, atms, recon, trans, batch, mesh) if timed else None
    del unet, atms, recon, trans, batch
    if torch.cuda.is_available() and str(device).startswith('cuda'):
        torch.cuda.empty_cache()
    return grads, steps, acts, norms


def floor_check(got, ref, tol, floor):
    """Each leaf within ``tol`` of its max (``chip_smoke.grad_deviation``'s scale)
    or within twice ``floor[leaf]``, the one-GPU bf16 step's own distance from its
    float32 twin: that distance is the reference's behaviour, not the port's
    (``tests/test_torch_bf16_parity.py``: on the CPU the JAX package's bf16
    gradients sit 0.87-1.60 of a leaf's max from float32, the port's 0.29-1.23).
    Returns the worst ratio of a leaf's deviation to its allowance, and that leaf."""
    top = max(float(g.abs().max()) for g in ref.values())
    worst = (-1.0, '')
    for k, r in ref.items():
        pre_norm_bias = k.endswith('conv.bias') or ('locnet.convnet' in k
                                                    and k.endswith('.bias'))
        scale = top if pre_norm_bias else max(float(r.abs().max()), 1e-30)
        allowed = max(tol * scale, 2.0 * floor[k])
        worst = max(worst, (float((got[k] - r).abs().max()) / allowed, k))
    return worst


def worst_leaves(grads, ref, n=4):
    """The ``n`` leaves that deviate most, scored as ``chip_smoke.grad_deviation``
    scores them: [(deviation, leaf)]."""
    top = max(float(g.abs().max()) for g in ref.values())
    rows = []
    for k, r in ref.items():
        pre_norm_bias = k.endswith('conv.bias') or ('locnet.convnet' in k
                                                    and k.endswith('.bias'))
        scale = top if pre_norm_bias else max(float(r.abs().max()), 1e-30)
        rows.append((float((grads[k] - r).abs().max()) / scale, k))
    return sorted(rows, reverse=True)[:n]


def _mesh_rank(rank, mesh_shape, device_type, branches, out):
    import torch.distributed as dist
    from acquisition_focus_tpu_torch.parallel.mesh import make_mesh
    if device_type == 'cuda':
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(mesh_shape)
    results = {}
    for name, overrides, timed in cases(device_type):
        grads, steps, acts, norms = run_case(name, overrides, timed, mesh.device, mesh,
                                             branches if name == 'f32' else None)
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, dict(steps or {}, flips=acts.flips,
                                              max_diff=acts.max_diff, r6_norms=norms[None]))
        results[name] = {'grads': grads[None], 'steps': per_rank}
    if rank == 0:
        torch.save(results, out)


def check_meshes(device, meshes=MESHES, tmp=None):
    """Section 3: the one-GPU references, then each mesh in its own process group.

    A bf16 leaf passes within MESH_GRAD_TOL of its max or within twice the
    one-GPU bf16 step's own distance from its float32 twin (the whole batch's,
    TF32 off), as the (E)Pix2Vox block tests allow twice the float32-float64 gap:
    a mesh's other summation orders move bf16 gradients as far as bf16 itself
    does. Failures are collected and returned, not raised.

    The step's gradients depend on the batch's layout on one GPU already: the
    mean of a batch's halves' gradients is not the whole batch's (view 2's
    localization chain turns the convolutions' other rounding at batch 1 into
    gradients 12x apart in bf16, 7e-4 of a leaf's max in float32 with the
    LeakyReLU slopes imposed). So a mesh with a data axis of d is held against the
    one-GPU step in its own layout (``first_grads(..., blocks=d)``); its deviation
    from the whole batch's, and the one-GPU layouts' from each other, are
    reported beside it. Returns {mesh: {case: numbers}}, the references' numbers,
    the layouts' and the failures."""
    from acquisition_focus_tpu_torch.parallel.mesh import mesh_processes, spawn_ranks
    cs = chip_smoke()
    blocks = tuple(sorted({1} | {m.get('data', 1) for m in meshes}))
    refs, layouts, failures = {}, {}, []
    for name, overrides, timed in cases(device):
        grads, steps, acts, norms = run_case(name, overrides, timed, device, blocks=blocks)
        refs[name] = {'grads': grads, 'steps': steps, 'branches': acts.records}
        if name != 'f32':
            twin = run_case(name + ' float32', dict(overrides, compute_dtype='float32'),
                            False, device)[0][1]
            refs[name]['floor'] = {k: float((g - twin[k]).abs().max())
                                   for k, g in grads[1].items()}
            dev32, leaf32 = cs.grad_deviation(grads[1], twin)
            layouts[f'{name} against float32'] = {'grad_dev': dev32, 'grad_dev_leaf': leaf32}
            log(f"one {device}, {name}: against its float32 twin (TF32 off): gradient "
                f"deviation {dev32:.3e} ({leaf32}); worst leaves "
                f"{worst_leaves(grads[1], twin)}")
        if timed:
            log(f"one {device}, {name}: {steps['s_step']:.4f} s/step, peak {steps['peak']} "
                f"B, step 0 loss {steps['loss0']!r}, launches per step "
                f"{steps['launches_per_step']}")
        for d in blocks[1:]:
            dev, leaf = cs.grad_deviation(grads[d], grads[1])
            layouts[f'{name} {d} blocks'] = {'grad_dev': dev, 'grad_dev_leaf': leaf,
                                             'r6_norms': norms[d]}
            log(f"one {device}, {name}: the batch in {d} row blocks against the whole "
                f"batch: gradient deviation {dev:.3e} ({leaf}); worst leaves "
                f"{worst_leaves(grads[d], grads[1])}; smallest R6 head vector norm "
                f"per view: whole {norms[1]}, blocks {norms[d]}")
    report = {}
    tmp = Path(tmp or tempfile.mkdtemp(prefix='smoke_mesh_'))
    for shape in meshes:
        n, d = mesh_processes(shape), shape.get('data', 1)
        key = json.dumps(shape)
        out = tmp / f"mesh_{'_'.join(f'{k}{v}' for k, v in shape.items())}.pt"
        t0 = time.perf_counter()
        spawn_ranks(_mesh_rank, n, args=(shape, device, refs['f32']['branches'], str(out)),
                    backend='nccl' if device == 'cuda' else 'gloo',
                    threads=None if device == 'cuda' else 1)
        log(f"mesh {shape}: {n} processes, {time.perf_counter() - t0:.1f} s")
        results = torch.load(out, weights_only=False)
        report[key] = {}
        for name, overrides, timed in cases(device):
            f32 = name == 'f32'
            tol = F32_GRAD_TOL if f32 else MESH_GRAD_TOL
            ref = refs[name]['grads'][d]
            got = results[name]['grads']
            dev, leaf = cs.grad_deviation(got, ref)
            whole, whole_leaf = cs.grad_deviation(got, refs[name]['grads'][1])
            row = {'grad_dev': dev, 'grad_dev_leaf': leaf, 'grad_tol': tol,
                   'grad_dev_whole_batch': whole, 'grad_dev_whole_batch_leaf': whole_leaf}
            log(f"  {name}: first-microbatch gradient deviation from one {device} "
                f"({'whole batch' if d == 1 else f'{d} row blocks'}) {dev:.3e} "
                f"({leaf}), tol {tol:g}; from the whole batch's {whole:.3e} ({whole_leaf})")
            ok = dev <= tol
            if not f32:
                ratio, rleaf = floor_check(got, ref, tol, refs[name]['floor'])
                row.update(floor_ratio=ratio, floor_ratio_leaf=rleaf)
                log(f"    against max({tol:g} of a leaf's max, twice one {device}'s bf16 "
                    f"distance from float32): worst ratio {ratio:.3f} ({rleaf})")
                ok = ratio <= 1.0
            if f32:
                ranks = results[name]['steps']
                row.update(imposed_flips=sum(r['flips'] for r in ranks),
                           act_max_diff=max(r['max_diff'] for r in ranks))
                log(f"    activation branches imposed from one {device}: "
                    f"{row['imposed_flips']} elements took the other sign on the mesh; "
                    f"inputs agree to {row['act_max_diff']:.3e} (tol {F32_ACT_TOL:g})")
                if not row['act_max_diff'] <= F32_ACT_TOL:
                    failures.append(f"mesh {shape} f32: activation inputs differ by "
                                    f"{row['act_max_diff']:.3e} from one {device}'s")
            if not ok:
                log(f"    worst leaves: {worst_leaves(got, ref)}")
                failures.append(f"mesh {shape} {name}: gradient of {leaf} deviates "
                                f"{dev:.3e} from one {device}'s")
            if timed:
                ref_steps = refs[name]['steps']
                ranks = results[name]['steps']
                rel = abs(ranks[0]['loss0'] - ref_steps['loss0']) / abs(ref_steps['loss0'])
                loss_tol = MESH_LOSS_TOL if not f32 else 1e-5
                for r, s in enumerate(ranks):
                    log(f"    rank {r}: {s['s_step']:.4f} s/step, peak {s['peak']} B, "
                        f"launches per step {s['launches_per_step']}")
                log(f"    step 0 loss {ranks[0]['loss0']!r} (one {device}: "
                    f"{ref_steps['loss0']!r}, rel diff {rel:.3e}, tol {loss_tol:g})")
                if not rel <= loss_tol:
                    failures.append(f"mesh {shape} {name}: step 0 loss "
                                    f"{ranks[0]['loss0']} vs {ref_steps['loss0']}")
                row.update(loss0=ranks[0]['loss0'], loss0_rel_diff=rel, ranks=ranks)
            report[key][name] = row
    single = {name: r['steps'] for name, r in refs.items() if r['steps']}
    for f in failures:
        log(f"FAILED: {f}")
    return report, single, layouts, failures


def _epix_rank(rank, mesh_shape, device_type, out):
    import torch.distributed as dist
    from acquisition_focus_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params
    cs = chip_smoke()
    if device_type == 'cuda':
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(mesh_shape)
    results = {}
    for model_type in EPIX_TYPES:
        spec = spec_for(dict(EPIX, model_type=model_type))
        unet, atms, recon, trans = cs.build_step(spec, mesh.device)
        shard_params(unet, atms, mesh)
        batch = shard_batch(epix_batch(spec, mesh.device), mesh, True)
        grads = float64_grads(spec, unet, atms, batch, mesh)
        steps = timed_steps(spec, unet, atms, recon, trans, batch, mesh) \
            if device_type == 'cuda' else {}
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, steps)
        results[model_type] = {'grads': grads, 'steps': per_rank}
        del unet, atms, recon, trans, batch
        if device_type == 'cuda':
            torch.cuda.empty_cache()
    if rank == 0:
        torch.save(results, out)


def check_epix2vox_meshes(device, meshes=MESHES, tmp=None):
    """(E)Pix2Vox and Pix2Vox (``config_dict_id21.json``'s ref stage: 2 views,
    binarized, fixed views; full size 128^3, batch 2 x accum 2, TF32 off) on one
    device, then on each mesh: the first microbatch's gradients in float64
    (:func:`float64_grads`) within EPIX_GRAD_TOL of each leaf's max
    (``chip_smoke.grad_deviation``'s scale) of one device's on the whole batch (a
    data mesh's batch norms take the whole batch's statistics, so it computes
    the whole batch's gradient); then in float32 step 0's loss within
    EPIX_LOSS_TOL (rel.), per rank s/step and peak memory. Failures are
    collected and returned. Returns ({mesh: {model type: numbers}}, one device's
    numbers, failures)."""
    from acquisition_focus_tpu_torch.parallel.mesh import mesh_processes, spawn_ranks
    cs = chip_smoke()
    refs, failures = {}, []
    for model_type in EPIX_TYPES:
        spec = spec_for(dict(EPIX, model_type=model_type))
        unet, atms, recon, trans = cs.build_step(spec, device)
        batch = epix_batch(spec, device)
        grads = float64_grads(spec, unet, atms, batch)
        steps = timed_steps(spec, unet, atms, recon, trans, batch, None) \
            if device == 'cuda' else {}
        refs[model_type] = {'grads': grads, 'steps': steps}
        log(f"one {device}, {model_type}: "
            + (f"{steps['s_step']:.4f} s/step, peak {steps['peak']} B, step 0 loss "
               f"{steps['loss0']!r}" if steps else "no timed steps on the CPU"))
        del unet, atms, recon, trans, batch
        if device == 'cuda':
            torch.cuda.empty_cache()
    report = {}
    tmp = Path(tmp or tempfile.mkdtemp(prefix='smoke_mesh_epix_'))
    for shape in meshes:
        n, key = mesh_processes(shape), json.dumps(shape)
        out = tmp / f"epix_{'_'.join(f'{k}{v}' for k, v in shape.items())}.pt"
        t0 = time.perf_counter()
        spawn_ranks(_epix_rank, n, args=(shape, device, str(out)),
                    backend='nccl' if device == 'cuda' else 'gloo',
                    threads=None if device == 'cuda' else 1)
        log(f"(E)Pix2Vox mesh {shape}: {n} processes, {time.perf_counter() - t0:.1f} s")
        results = torch.load(out, weights_only=False)
        report[key] = {}
        for model_type in EPIX_TYPES:
            ref, got = refs[model_type], results[model_type]
            dev, leaf = cs.grad_deviation(got['grads'], ref['grads'])
            row = {'grad_dev': dev, 'grad_dev_leaf': leaf, 'grad_tol': EPIX_GRAD_TOL}
            log(f"  {model_type}: float64 first-microbatch gradient deviation from one "
                f"{device} (whole batch) {dev:.3e} ({leaf}), tol {EPIX_GRAD_TOL:g}")
            if not dev <= EPIX_GRAD_TOL:
                log(f"    worst leaves: {worst_leaves(got['grads'], ref['grads'])}")
                failures.append(f"(E)Pix2Vox mesh {shape} {model_type}: gradient of {leaf} "
                                f"deviates {dev:.3e} from one {device}'s")
            if ref['steps']:
                ranks = got['steps']
                loss0 = ref['steps']['loss0']
                rel = abs(ranks[0]['loss0'] - loss0) / abs(loss0)
                for r, st in enumerate(ranks):
                    log(f"    rank {r}: {st['s_step']:.4f} s/step, peak {st['peak']} B")
                log(f"    step 0 loss {ranks[0]['loss0']!r} (one {device}: {loss0!r}, rel "
                    f"diff {rel:.3e}, tol {EPIX_LOSS_TOL:g})")
                if not rel <= EPIX_LOSS_TOL:
                    failures.append(f"(E)Pix2Vox mesh {shape} {model_type}: step 0 loss "
                                    f"{ranks[0]['loss0']} vs {loss0}")
                row.update(loss0=ranks[0]['loss0'], loss0_rel_diff=rel, ranks=ranks)
            report[key][model_type] = row
    single = {mt: r['steps'] for mt, r in refs.items()}
    for f in failures:
        log(f"FAILED: {f}")
    return report, single, failures


SWEEPS = {   # name: (meta config overrides, stages, what it is)
    'unet': (dict(use_pallas_conv3d='full', theta_refresh_every=2,
                  mesh_shape={'data': 2, 'model': 2}),
             ['opt_view0', 'opt_view1', 'opt_view2', 'ref'],
             "DEFAULTS with 'full', theta_refresh_every 2"),
    'epix2vox': (dict(model_type='hybrid-EPix2Vox', base_views=['p2CH', 'p4CH'],
                      use_binarized_labels=True, stage_override='ref',
                      mesh_shape={'data': 2}),
                 ['ref'], "config_dict_id21.json (hybrid-EPix2Vox, p2CH + p4CH, "
                          "binarized, the ref stage)"),
}


def run_mesh_sweep(tmp, device, small=False, sweep='unet'):
    """Section 4: a CLI sweep (``SWEEPS[sweep]``: the hybrid U-Net's on {'data': 2,
    'model': 2}, or (E)Pix2Vox's on {'data': 2}), its checkpoints read back, and
    the last one loaded into a one-device ``run_dl``."""
    from acquisition_focus_tpu_torch import main as cli
    from acquisition_focus_tpu_torch.data.cache import load_or_build
    from acquisition_focus_tpu_torch.data.mmwhs import MMWHSDataset
    from acquisition_focus_tpu_torch.data.synthetic import write_phantom_dataset
    from acquisition_focus_tpu_torch.engine.checkpoint import load_checkpoint
    from acquisition_focus_tpu_torch.engine.runner import load_config, run_dl
    cs = chip_smoke()
    tmp = Path(tmp)
    data = tmp / 'data'
    write_phantom_dataset(data, n_cases=8, shape=(32 if small else 128,) * 3, n_test=2)
    state_path = tmp / 'sweep_state.json'
    overrides, stages, what = SWEEPS[sweep]
    meta = dict(epochs=2, save_every='best', do_output=True,
                sweep_state_path=str(state_path), log_dir=str(tmp / 'runs'),
                mdl_save_prefix=str(tmp / 'models'), dataset=['synthetic', str(data)],
                fold_override=0, use_caching=False, **overrides,
                **(SMALL if small and sweep == 'unet' else {}))
    (tmp / 'meta.json').write_text(json.dumps(meta))
    log(f"mesh sweep: python -m acquisition_focus_tpu_torch.main on {meta['mesh_shape']}: "
        f"{what}, epochs 2, fold 0, 8 phantom cases at {32 if small else 128}^3")
    if device == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli.main(['--meta_config_path', str(tmp / 'meta.json'), '--base_dir', str(tmp)],
             device=device)
    sweep_s = time.perf_counter() - t0
    completed, keys, epochs_total = cs.check_sweep(state_path, tmp / 'runs', stages)
    log(f"  CLI run (build + spawn + sweep) {sweep_s:.1f} s, epochs {epochs_total:.3f} s")

    config = load_config(None, tmp / 'meta.json')
    save = completed[keys[-1]]['save_path']
    ck = load_checkpoint(save)
    test = load_or_build(MMWHSDataset, data, config, 'test', device=device)
    # the test phase of the epoch after the checkpoint's
    one = dict(config, mesh_shape=None, model_checkpoint_path=save,
               epochs=int(ck['epoch']) + 2, log_dir=str(tmp / 'runs_one'))
    run_dl(str(tmp), one, (0, ([], [])), test_dataset=test, run_test_once_only=True,
           run_name='one_device', device=device)
    recs = [json.loads(line) for line in
            (tmp / 'runs_one' / 'one_device' / 'metrics.jsonl').read_text().splitlines()]
    test_loss = [r['losses/test_loss'] for r in recs if 'losses/test_loss' in r]
    moments = {tuple(s['exp_avg'].shape) for s in ck['recon_opt']['state'].values()}
    params = {tuple(v.shape) for v in ck['unet'].values()}
    log(f"  {Path(save).name} loaded into a one-{device} run_dl: test loss {test_loss}; "
        f"every AdamW moment at a parameter's full shape: {moments <= params}")
    if not (test_loss and all(math.isfinite(v) for v in test_loss) and moments <= params):
        raise AssertionError(f"the mesh checkpoint {save} did not load into one device")
    return {'sweep_s': sweep_s, 'epochs_s': epochs_total, 'test_loss_one_device': test_loss}


def interconnect():
    """What the host reports of the links between its GPUs: ``nvidia-smi topo -m``,
    and where that fails, ``nvidia-smi nvlink --status`` and torch's peer-access
    matrix."""
    out = []
    for cmd in (['nvidia-smi', 'topo', '-m'], ['nvidia-smi', 'nvlink', '--status']):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.append(f"$ {' '.join(cmd)} (exit {proc.returncode})\n"
                   f"{(proc.stdout or proc.stderr).strip()}")
        if proc.returncode == 0 and proc.stdout.strip():
            break
    n = torch.cuda.device_count()
    out.append('peer access: ' + '; '.join(
        f"{i}: {[int(torch.cuda.can_device_access_peer(i, j)) for j in range(n)]}"
        for i in range(n)))
    return '\n'.join(out)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    parser.add_argument('--cases', default='unet,epix2vox',
                        help="comma-separated: 'unet' (the hybrid U-Net's kernels, "
                             "steps and sweep), 'epix2vox' ((E)Pix2Vox's steps and sweep)")
    args = parser.parse_args(argv)
    cases_run = set(args.cases.split(','))
    if not cases_run <= {'unet', 'epix2vox'}:
        parser.error(f"--cases: unknown {sorted(cases_run - {'unet', 'epix2vox'})}")
    need = max(math.prod(m.values()) for m in MESHES)
    if args.device == 'cuda':
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"smoke_mesh: needs {need} GPUs, found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             check=True).stdout.strip()
        log(smi)
        log(interconnect())
        log(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
            f"count {torch.cuda.device_count()}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        from acquisition_focus_tpu_torch.ops.kernels import _lib
        t0 = time.perf_counter()
        _lib.library()
        log(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
        kernels = {}
        if 'unet' in cases_run:
            cs = chip_smoke()
            chk = cs.Checker()
            cs.check_conv3d(chk, np.random.default_rng(5), CONVS_MESH, MESH)
            cs.check_conv3d_grads(chk, CONVS_MESH, MESH)
            kernels = {k + MESH: chk.rows[k + MESH]
                       for k in ('conv3d_fwd', 'conv3d_dx', 'conv3d_wgrad')}
            torch.cuda.empty_cache()
    else:
        smi, kernels = 'cpu', {}
    result, failures = {}, []
    with tempfile.TemporaryDirectory(prefix='smoke_mesh_') as tmp:
        if 'unet' in cases_run:
            report, single, layouts, fails = check_meshes(args.device, tmp=tmp)
            failures += fails
            result.update(one_device=single, one_device_layouts=layouts, meshes=report,
                          sweep=run_mesh_sweep(Path(tmp) / 'sweep', args.device,
                                               small=args.device == 'cpu'))
        if 'epix2vox' in cases_run:
            report, single, fails = check_epix2vox_meshes(args.device, tmp=tmp)
            failures += fails
            result.update(epix2vox_one_device=single, epix2vox_meshes=report,
                          epix2vox_sweep=run_mesh_sweep(
                              Path(tmp) / 'epix_sweep', args.device,
                              small=args.device == 'cpu', sweep='epix2vox'))
    if failures:
        raise AssertionError(f"{len(failures)} mesh check(s) failed: {failures}")
    log(smi)
    log(json.dumps({'ok': True, 'device': smi, 'kernels': kernels, **result}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
