#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``acquisition_focus_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

1. Device: the card's name and power limit, torch and CUDA versions; build the CUDA
   kernels from ``acquisition_focus_tpu_torch/csrc`` (nvcc, sm_90a) and time it.
2. Kernels at the main path's shapes: each kernel against its plain PyTorch
   version on the same CUDA tensors, in bfloat16 and float32 (TF32 off), with the
   error against a stated tolerance and both times (CUDA events, after warm-up):
   K1 forward/backward, K2, K3 forward, K3 as the conv's input gradient, and K4
   (the conv's weight gradient).
3. The training step: the default configuration's step
   (``spec_from_config(DEFAULTS, 6, 3)``: hybrid U-Net at reference widths, 3 views,
   6 classes, 128^3 @ 192 mm, batch 2 x accum 2, bf16) on phantom labels, random
   weights from a seed: 1 warm-up and 3 timed steps with ``use_pallas_conv3d='fwd'``
   (K1, K2, K3 forward), then the same 4 steps from the same weights, batch and
   generator seed with ``'full'`` (K3 also as the input gradient, K4 as the weight
   gradient). Step 0's loss must agree between the two.
4. The sweep: ``stage_sweep_run`` -> ``run_dl`` at full width (the same
   configuration under ``'full'`` with ``theta_refresh_every=2``, 2 epochs per
   stage, all four stages ``opt_view0..2`` and ``ref``) on an in-memory phantom
   dataset: locnet epoch, ``theta_pass``, cached-theta epoch, ``eval_step``,
   device surface metrics, checkpoints and their chaining. Every kernel must have
   launched during the sweep; frozen views' ATMs must stay bit-equal. Per stage it
   prints what the run wrote (sweep state, ``metrics.jsonl``); then it times the
   runner's calls apart once: a locnet and a cached-theta step, the heavy metrics,
   a checkpoint load and save.
5. A small float32 configuration on the GPU held against the same forward,
   ``theta_pass`` and ``eval_step`` on the CPU, where every wrapper takes its plain
   version.
6. The last line is {"ok": true, "device": {...}}; the line before it lists the
   kernels as JSON: launches during the sweep, the largest error against the plain
   version, and the bf16 kernel and plain times summed over the shapes checked.
   Any failure raises and exits non-zero.
"""

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

WARMUP = 2


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn`` on the current stream, after warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotations(rng, n, offset):
    """(n, 4, 4) random proper rotations with offsets in [-offset, offset]."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out[i, :3, :3] = q
        out[i, :3, 3] = rng.uniform(-offset, offset, 3)
    return torch.tensor(out, dtype=torch.float32, device='cuda')


class Checker:
    """Collects each kernel's comparison with its plain version."""

    def __init__(self):
        self.rows = {}

    def compare(self, kernel, what, got, ref, tol, normalize=False):
        got, ref = got.float(), ref.float()
        if got.shape != ref.shape:
            raise AssertionError(f"{kernel} {what}: shape {tuple(got.shape)} != "
                                 f"{tuple(ref.shape)}")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        rel = err / max(scale, 1e-30)
        bad = (rel if normalize else err) > tol or not np.isfinite(err)
        kind = 'max_abs/max|ref|' if normalize else 'max_abs'
        log(f"  {kernel:20s} {what:30s} max_abs {err:.3e}  max_rel {rel:.3e}  "
            f"tol ({kind}) {tol:g}  {'FAIL' if bad else 'ok'}")
        if bad:
            raise AssertionError(f"{kernel} {what}: error {err:.3e} (rel {rel:.3e}) "
                                 f"over tolerance {tol:g}")
        row = self.rows.setdefault(kernel, {'max_abs_err': 0.0})
        row['max_abs_err'] = max(row['max_abs_err'], err)
        return err

    def timed(self, kernel, what, kernel_fn, plain_fn, iters, main=False):
        ms, plain_ms = cuda_ms(kernel_fn, iters), cuda_ms(plain_fn, iters)
        log(f"  {kernel:20s} {what:30s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if main:
            row = self.rows.setdefault(kernel, {'max_abs_err': 0.0})
            row['ms'] = row.get('ms', 0.0) + ms
            row['plain_ms'] = row.get('plain_ms', 0.0) + plain_ms


def check_volume_resample(chk, rng):
    """K2 at the prescan resample: (2, 6, 128^3) label volume, 6 affines (3 views
    x 2 samples), 128^3 out."""
    from acquisition_focus_tpu_torch.ops.kernels.volume_resample import (
        volume_resample_cuda)
    from acquisition_focus_tpu_torch.ops.resample import grid_sample
    log("K2 volume_resample: (2, 6, 128^3) -> (6, 6, 128^3)")
    out = (128, 128, 128)
    theta = rotations(rng, 6, 0.1)
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        vol = torch.rand((2, 6) + out, device='cuda').to(dtype)
        got = volume_resample_cuda(vol, theta, out)
        ref = grid_sample(vol, theta, out)
        name = str(dtype).split('.')[-1]
        chk.compare('volume_resample', f'{name} out', got, ref, tol)
        chk.timed('volume_resample', name,
                  lambda: volume_resample_cuda(vol, theta, out),
                  lambda: grid_sample(vol, theta, out), 10,
                  main=dtype == torch.bfloat16)
        del vol, got, ref


def check_plane_resample(chk, rng):
    """K1 forward and backward at skip-connector levels 0 (S 128, C 16) and 5
    (S 4, C 256), batch 2; tolerances on errors divided by the reference's max.
    The kernel maps output voxels to plane coordinates through the (B, 3, 4)
    coefficient form, the plain version through normalized coordinates: in float32
    the two round differently by ~1e-5 voxel at S = 128, hence 2e-4 (forward)."""
    from acquisition_focus_tpu_torch.ops.kernels import affine_coefficients
    from acquisition_focus_tpu_torch.ops.kernels.plane_resample import (
        plane_resample, plane_resample_bwd, plane_resample_fwd)
    from acquisition_focus_tpu_torch.ops.resample import sample_slice_into_volume
    for S, C in ((128, 16), (4, 256)):
        log(f"K1 plane_resample: (2, {C}, {S}, {S}) -> (2, {C}, {S}^3)")
        theta = rotations(rng, 2, 0.2)
        coefs = affine_coefficients(theta, (S,) * 3, (S,) * 3).contiguous()
        for dtype, tol_f, tol_b in ((torch.bfloat16, 1e-2, 3e-2),
                                    (torch.float32, 2e-4, 1e-3)):
            name = f"{str(dtype).split('.')[-1]} S{S}"
            slices = torch.randn((2, C, S, S), device='cuda').to(dtype)
            g = torch.randn((2, C, S, S, S), device='cuda').to(dtype)

            def grads(fn):
                s = slices.clone().requires_grad_()
                t = theta.clone().requires_grad_()
                out = fn(s, t, S)
                ds, dt = torch.autograd.grad(out, (s, t), g)
                return out.detach(), ds, dt

            out_k, ds_k, dt_k = grads(plane_resample)
            out_p, ds_p, dt_p = grads(sample_slice_into_volume)
            chk.compare('plane_resample_fwd', f'{name} out', out_k, out_p, tol_f, True)
            chk.compare('plane_resample_bwd', f'{name} d_slices', ds_k, ds_p, tol_b, True)
            chk.compare('plane_resample_bwd', f'{name} d_theta', dt_k, dt_p, tol_b, True)

            main = dtype == torch.bfloat16
            iters = 20 if S < 64 else 10
            with torch.no_grad():
                chk.timed('plane_resample_fwd', name,
                          lambda: plane_resample_fwd(slices, coefs, S),
                          lambda: sample_slice_into_volume(slices, theta, S),
                          iters, main)
            s = slices.clone().requires_grad_()
            t = theta.clone().requires_grad_()
            out_graph = sample_slice_into_volume(s, t, S)
            chk.timed('plane_resample_bwd', name,
                      lambda: plane_resample_bwd(slices, coefs, g),
                      lambda: torch.autograd.grad(out_graph, (s, t), g,
                                                  retain_graph=True),
                      iters, main)
            del slices, g, out_k, out_p, ds_k, ds_p, out_graph


def check_conv3d(chk, rng):
    """K3 at the decoder's full-resolution convs: (2, 96, 128^3) -> 48 and
    (2, 48, 128^3) -> 48; the kernel's time includes the wrapper's weight layout
    conversion. Tolerances on errors divided by the reference's max."""
    import torch.nn.functional as F
    from acquisition_focus_tpu_torch.ops.kernels.conv3d import conv3d
    for ci in (96, 48):
        log(f"K3 conv3d: (2, {ci}, 128^3) -> 48")
        w = torch.randn((48, ci, 3, 3, 3), device='cuda') / (27 * ci) ** 0.5
        b = torch.randn((48,), device='cuda') * 0.1
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            name = f"{str(dtype).split('.')[-1]} Ci{ci}"
            x = torch.randn((2, ci, 128, 128, 128), device='cuda').to(dtype)
            with torch.no_grad():
                got = conv3d(x, w, b)
                ref = F.conv3d(x, w.to(dtype), b.to(dtype), padding=1)
                chk.compare('conv3d_fwd', f'{name} out', got, ref, tol, True)
                del got, ref
                chk.timed('conv3d_fwd', name, lambda: conv3d(x, w, b),
                          lambda: F.conv3d(x, w.to(dtype), b.to(dtype), padding=1),
                          3, main=dtype == torch.bfloat16)
            del x


def check_conv3d_grads(chk):
    """K3 as the input gradient and K4 at the decoder's full-resolution convs: x
    (2, 96 or 48, 128^3), cotangent (2, 48, 128^3). The gradients come from
    ``torch.autograd.grad`` through ``conv3d(x, w, b, kernel_dx=True,
    kernel_dw=True)``, the main path's backward (its weight flip and its guards),
    with float32 weights as the model holds them. Each is held against the
    library's gradient in float32 (TF32 off) on the same inputs, so the bf16 check
    sees the kernel's own error and not the library's bf16 rounding; errors divided
    by the reference's max. Tolerances from the first chip run (NVIDIA H100, 700 W):
    K4 measured 7.6e-05 (bf16) and 5.4e-06 (f32), K3-as-dx 3.2e-03 (bf16, one bf16
    rounding of the output) and 2.2e-06 (f32). Times are of the kernels' direct
    launches against the library in the same dtype (the gradients the 'fwd' mode
    takes)."""
    from acquisition_focus_tpu_torch.ops.kernels.conv3d import (
        conv3d, conv3d_fwd_cuda, conv3d_wgrad_cuda)
    grad_input, grad_weight = torch.nn.grad.conv3d_input, torch.nn.grad.conv3d_weight
    for ci in (96, 48):
        log(f"K3 as dx, K4 wgrad: x (2, {ci}, 128^3), cotangent (2, 48, 128^3)")
        w_shape = (48, ci, 3, 3, 3)
        w32 = torch.randn(w_shape, device='cuda') / (27 * ci) ** 0.5
        b32 = torch.zeros(48, device='cuda')
        for dtype, tol_dx, tol_dw in ((torch.bfloat16, 1e-2, 5e-4),
                                      (torch.float32, 1e-4, 5e-5)):
            name = f"{str(dtype).split('.')[-1]} Ci{ci}"
            main = dtype == torch.bfloat16
            x = torch.randn((2, ci, 128, 128, 128), device='cuda').to(dtype)
            g = torch.randn((2, 48, 128, 128, 128), device='cuda').to(dtype)
            w = w32.to(dtype)
            xg, wg = x.clone().requires_grad_(), w32.clone().requires_grad_()
            dx, dw = torch.autograd.grad(conv3d(xg, wg, b32, True, True), (xg, wg), g)
            del xg, wg
            chk.compare('conv3d_dx', f'{name} dx', dx,
                        grad_input(x.shape, w.float(), g.float(), padding=1), tol_dx, True)
            chk.compare('conv3d_wgrad', f'{name} dw', dw,
                        grad_weight(x.float(), w_shape, g.float(), padding=1), tol_dw, True)
            del dx, dw
            zb = torch.zeros(ci, device='cuda')
            w_t = w.flip(2, 3, 4).transpose(0, 1)
            chk.timed('conv3d_dx', name, lambda: conv3d_fwd_cuda(g, w_t, zb, 'conv3d_dx'),
                      lambda: grad_input(x.shape, w, g, padding=1), 3, main)
            chk.timed('conv3d_wgrad', name, lambda: conv3d_wgrad_cuda(x, g),
                      lambda: grad_weight(x, w_shape, g, padding=1), 3, main)
            del x, g
            torch.cuda.empty_cache()


def phantom_batch(spec, device):
    """(accum, B, ...) batch of phantom labels: 4 samples at the hires grid, their
    NIfTI affines, identity view affines (as the JAX package's bench)."""
    from acquisition_focus_tpu_torch.data import make_heart_phantom
    accum, B = spec.num_grad_accum_steps, 2
    S = tuple(spec.hires_fov_vox)
    spacing = tuple(m / v for m, v in zip(spec.hires_fov_mm, spec.hires_fov_vox))
    samples = [make_heart_phantom(shape=S, seed=i, spacing=spacing)
               for i in range(accum * B)]
    label = np.stack([s[0] for s in samples]).reshape((accum, B) + S)
    nii = np.stack([s[2] for s in samples]).reshape(accum, B, 4, 4)
    views = np.broadcast_to(np.eye(4), (accum, spec.n_views, B, 4, 4))
    return {'label': torch.tensor(label, device=device),
            'nii_affine': torch.tensor(nii, dtype=torch.float32, device=device),
            'view_affines': torch.tensor(np.array(views), dtype=torch.float32,
                                         device=device)}


def build_step(spec, device, seed=0):
    from acquisition_focus_tpu_torch.engine import train
    from acquisition_focus_tpu_torch.engine.optimizers import (
        make_reconstruction_optimizer, make_transform_optimizer)
    unet, atms = train.make_models(spec, device)
    train.init_params(unet, atms, torch.Generator().manual_seed(seed))
    recon = make_reconstruction_optimizer(unet.parameters(), 1e-3, updates_per_epoch=10)
    trans = make_transform_optimizer(atms.parameters(), 1e-3, epochs=80,
                                     updates_per_epoch=10)
    return unet, atms, recon, trans


STEP_KERNELS = {
    'fwd': ('plane_resample_fwd', 'plane_resample_bwd', 'volume_resample', 'conv3d_fwd'),
    'full': ('plane_resample_fwd', 'plane_resample_bwd', 'volume_resample', 'conv3d_fwd',
             'conv3d_dx', 'conv3d_wgrad'),
}


def run_steps(mode):
    """4 training steps of the default configuration at full width on the card,
    with ``use_pallas_conv3d=mode``; every kernel the mode routes through must
    launch. Weights, batch and augmentation generator come from seed 0."""
    from acquisition_focus_tpu_torch.engine import train
    from acquisition_focus_tpu_torch.engine.runner import DEFAULTS, spec_from_config
    from acquisition_focus_tpu_torch.ops.kernels import _lib
    spec = spec_from_config(dict(DEFAULTS, use_pallas_conv3d=mode), 6, 3)
    log(f"steps: spec_from_config(DEFAULTS, 6, 3) with use_pallas_conv3d={mode!r}: "
        f"hires {spec.hires_fov_vox}, prescan {spec.prescan_fov_vox}, base_features "
        f"{spec.base_features}, locnet_width {spec.locnet_width}, {spec.n_views} views, "
        f"{spec.num_classes} classes, accum {spec.num_grad_accum_steps} x batch 2, "
        f"{spec.compute_dtype}, {spec.view_optimization_mode}, "
        f"augment_input={spec.augment_input}")
    unet, atms, recon, trans = build_step(spec, 'cuda')
    n_params = sum(p.numel() for m in (unet, atms) for p in m.parameters())
    batch = phantom_batch(spec, 'cuda')
    gen = torch.Generator().manual_seed(0)
    n_slices = spec.num_grad_accum_steps * 2 * spec.n_views
    log(f"  params {n_params}; batch label {tuple(batch['label'].shape)}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    times, losses = [], []
    for step in range(4):
        t0 = time.perf_counter()
        metrics = train.train_step(spec, unet, atms, recon, trans, batch, gen)
        loss = float(metrics['loss'])        # synchronizes
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        dice = metrics['dice']
        log(f"  step {step}{' (warm-up)' if step == 0 else ''}: loss {loss!r}  "
            f"{dt:.3f} s  dice shape {tuple(dice.shape)}")
        if not np.isfinite(loss) or dice.shape != (n_slices // spec.n_views,
                                                   spec.num_classes):
            raise AssertionError(f"step {step}: loss {loss}, dice {tuple(dice.shape)}")
        losses.append(loss)
        if step:
            times.append(dt)
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    s_step = sum(times) / len(times)
    log(f"  [{mode}] s/step {s_step:.4f} (mean of {len(times)})  slices/s "
        f"{n_slices / s_step:.4f}  ({n_slices} slices/step)  max_memory_allocated "
        f"{peak} B ({peak / 2**30:.2f} GiB)")
    log(f"  kernel launches in the 4 steps: {launches}")
    missing = [k for k in STEP_KERNELS[mode] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for p in list(unet.parameters()) + list(atms.parameters()):
        if not torch.isfinite(p).all():
            raise AssertionError("non-finite parameter after the steps")
    del unet, atms, recon, trans, batch
    torch.cuda.empty_cache()
    return {'losses': losses, 's_step': s_step, 'peak': peak, 'launches': launches}


def compare_modes(fwd, full):
    """Step 0 runs the same forward in both modes (the modes differ only in the
    gradients), so its loss must agree to 1e-6 of its value; the later steps
    start from weights updated with other gradient arithmetic (K3 as dx, K4's
    f32 weight gradient instead of cuDNN's bf16 one) and may drift: 1e-2."""
    for step, (a, b) in enumerate(zip(fwd['losses'], full['losses'])):
        rel = abs(a - b) / max(abs(a), 1e-30)
        tol = 1e-6 if step == 0 else 1e-2
        log(f"  loss step {step}: fwd {a!r}  full {b!r}  rel diff {rel:.3e}  tol {tol:g}"
            f"  {'bit-equal' if a == b else ''}")
        if not rel <= tol:
            raise AssertionError(f"'full' step {step} loss {b} vs 'fwd' {a}: rel {rel:.3e}")
    log(f"  'fwd' {fwd['s_step']:.4f} s/step, peak {fwd['peak']} B; 'full' "
        f"{full['s_step']:.4f} s/step, peak {full['peak']} B")


def host_s(fn, calls=3):
    """Mean host seconds of calls 2..``calls`` of ``fn``, each ending in a sync."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sum(times[1:]) / (calls - 1)


def run_sweep(tmp):
    """The stage sweep at full width: ``stage_sweep_run`` -> ``run_dl`` for
    opt_view0..2 and ref, 2 epochs each (epoch 0 trains the locnet, epoch 1 runs
    from cached thetas and computes the heavy metrics on the device), on 10
    phantom training cases (8 train, 2 val) and 2 test cases at 128^3. Per stage
    it reads what the run writes: the sweep state (saves, the transform checkpoint
    each opt stage loaded) and ``metrics.jsonl`` (epoch seconds, scores)."""
    from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
    from acquisition_focus_tpu_torch.data.phantom import phantom_cases
    from acquisition_focus_tpu_torch.engine.checkpoint import load_checkpoint
    from acquisition_focus_tpu_torch.engine.runner import load_config
    from acquisition_focus_tpu_torch.main import get_std_stages, stage_sweep_run
    from acquisition_focus_tpu_torch.ops.kernels import _lib

    state_path = tmp / 'sweep_state.json'
    config = load_config(overrides=dict(
        epochs=2, use_pallas_conv3d='full', theta_refresh_every=2, save_every='best',
        do_output=True, sweep_state_path=str(state_path),
        log_dir=str(tmp / 'runs'), mdl_save_prefix=str(tmp / 'models')))
    spacing = tuple(m / v for m, v in zip(config['hires_fov_mm'], config['hires_fov_vox']))
    n_views = len(config['base_views'])
    t0 = time.perf_counter()
    train_ds = BaseDataset.from_cases(
        phantom_cases(10, config['hires_fov_vox'], spacing, n_views), config)
    test_ds = BaseDataset.from_cases(
        phantom_cases(2, config['hires_fov_vox'], spacing, n_views, first_seed=100),
        config, state='test')
    fold = (0, (list(range(8)), [8, 9]))
    log(f"sweep: DEFAULTS with epochs 2, use_pallas_conv3d 'full', theta_refresh_every 2, "
        f"save_every 'best'; {n_views} views, {config['hires_fov_vox']} @ "
        f"{config['hires_fov_mm']} mm, batch {config['batch_size']} x accum "
        f"{config['num_grad_accum_steps']}, {config['compute_dtype']}; phantom cases "
        f"built in {time.perf_counter() - t0:.1f} s (8 train, 2 val, 2 test)")
    log(f"  free disk under the run directory: {shutil.disk_usage(tmp).free} B")

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    stage_sweep_run(str(tmp), 'smoke', config, fold, get_std_stages(config), train_ds,
                    test_ds, False)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    log(f"  sweep {sweep_s:.1f} s; kernel launches in the sweep: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in the sweep: {missing}")

    completed = json.loads(state_path.read_text())['completed']
    keys = list(completed)
    if [k.split('/')[-1] for k in keys] != ['opt_view0', 'opt_view1', 'opt_view2', 'ref']:
        raise AssertionError(f"sweep state lists the stages {keys}")
    epochs_total = 0.0
    for i, key in enumerate(keys):
        rec = completed[key]
        run_name = rec['run_name']
        recs = [json.loads(line) for line in
                (tmp / 'runs' / run_name / 'metrics.jsonl').read_text().splitlines()]

        def last(name):
            vals = [r[name] for r in recs if name in r]
            return vals[-1] if vals else float('nan')

        losses = [r[k] for r in recs for k in r if k.startswith('losses/')]
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{key}: non-finite or missing losses {losses}")
        epoch_s = [r['perf/epoch_s'] for r in recs if 'perf/epoch_s' in r]
        epochs_total += sum(epoch_s)
        save = rec['save_path']
        if not save or Path(save).name != f"{run_name}_best":
            raise AssertionError(f"{key}: no checkpoint of its own ({save})")
        log(f"  {key}: epoch s {epoch_s}; val dice "
            f"{last('scores/val_mean_oa_exclude_bg_dice'):.4f}, test dice "
            f"{last('scores/test_mean_oa_exclude_bg_dice'):.4f}, val HD95 "
            f"{last('scores/val_mean_oa_exclude_bg_hd95'):.3f} mm, test HD95 "
            f"{last('scores/test_mean_oa_exclude_bg_hd95'):.3f} mm; checkpoint "
            f"{Path(save).stat().st_size} B")
        if not key.split('/')[-1].startswith('opt_view') or i == 0:
            continue
        prev = completed[keys[i - 1]]['save_path']
        if rec['transform_model_checkpoint_path'] != prev:
            raise AssertionError(f"{key}: transform checkpoint "
                                 f"{rec['transform_model_checkpoint_path']} is not the "
                                 f"previous stage's save {prev}")
        k = int(key[-1])
        before, after = load_checkpoint(prev)['atms'], load_checkpoint(save)['atms']
        frozen = [n for n in before if int(n.split('.')[0]) < k]
        changed = [n for n in frozen if not torch.equal(before[n], after[n])]
        moved = [n for n in after if n.startswith(f'{k}.')
                 and not torch.equal(before[n], after[n])]
        log(f"    frozen views 0..{k - 1}: {len(frozen)} tensors bit-equal to "
            f"{Path(prev).name}: {not changed}; view {k} moved: {len(moved)} tensors")
        if changed or not moved:
            raise AssertionError(f"{key}: frozen ATM tensors changed {changed[:3]}, "
                                 f"trained view moved {len(moved)}")
    log(f"  epochs {epochs_total:.3f} s of the sweep's {sweep_s:.3f} s; the rest is the "
        f"stages' model builds, checkpoint loads and saves")
    torch.cuda.empty_cache()
    time_runner_calls(tmp, config, completed[keys[-2]]['save_path'])
    return launches


def time_runner_calls(tmp, config, save_path):
    """What an epoch's seconds in ``metrics.jsonl`` hold but do not break out, timed
    once after the sweep at its configuration (random weights, the phantom batch):
    a training step with the locnets and one from ``theta_pass``'s cached thetas,
    the heavy metrics of one evaluation batch (``val_batch_size`` 1), and the load
    and save of an opt stage's checkpoint."""
    import dataclasses
    from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
    from acquisition_focus_tpu_torch.engine import runner, train
    from acquisition_focus_tpu_torch.engine.checkpoint import (
        load_checkpoint, save_checkpoint)
    spec = runner.spec_from_config(config, 6, len(config['base_views']))
    cached = dataclasses.replace(spec, theta_source='cached')
    unet, atms, recon, trans = build_step(spec, 'cuda')
    batch = phantom_batch(spec, 'cuda')
    thetas = torch.stack([train.theta_pass(spec, atms, {k: v[i] for k, v in batch.items()})
                          for i in range(spec.num_grad_accum_steps)])
    one = {'label': batch['label'][0, :1], 'nii_affine': batch['nii_affine'][0, :1],
           'view_affines': batch['view_affines'][0, :, :1]}
    pred = train.eval_step(spec, unet, atms, one)['pred']
    gen = torch.Generator().manual_seed(0)
    ck = load_checkpoint(save_path)
    calls = (
        ('train_step, theta_source locnet',
         lambda: train.train_step(spec, unet, atms, recon, trans, batch, gen)),
        ('train_step, theta_source cached',
         lambda: train.train_step(cached, unet, atms, recon, trans,
                                  dict(batch, thetas=thetas), gen)),
        ('heavy metrics, one 128^3 batch',
         lambda: runner.heavy_scores({}, spec, pred, one['label'], one['nii_affine'],
                                     BaseDataset.label_tags)),
        (f'checkpoint load ({Path(save_path).stat().st_size} B)',
         lambda: load_checkpoint(save_path)),
        ('checkpoint save', lambda: save_checkpoint(tmp / 'timed_save', ck)),
    )
    log("runner calls, timed apart (host clock, each call ending in a sync, mean of "
        "calls 2-3):")
    for what, fn in calls:
        log(f"  {what}: {host_s(fn):.4f} s")
    del unet, atms, recon, trans, batch, ck
    torch.cuda.empty_cache()


def check_small_reference():
    """A float32 forward, ``theta_pass`` and ``eval_step`` of a narrow 32^3
    configuration on the GPU (kernels K1 and K2; K3 needs W % 128 == 0) against
    the same calls on the CPU (plain versions), from the same weights and phantom
    batch. Three U-Net levels keep the smallest instance norm at 8 x 8: over 2 x 2
    it amplifies rounding differences."""
    from acquisition_focus_tpu_torch.data import make_heart_phantom
    from acquisition_focus_tpu_torch.engine import train
    spec = train.StageSpec(
        n_views=2, num_classes=6, n_active_views=2, view_optimization_mode='opt-all',
        use_affine_theta=True, hires_fov_mm=(48.0,) * 3, hires_fov_vox=(32,) * 3,
        slice_fov_mm=(48.0, 48.0, 1.5), slice_fov_vox=(32, 32, 1),
        prescan_fov_mm=(48.0,) * 3, prescan_fov_vox=(32,) * 3, compute_dtype='float32',
        augment_input=False, base_features=(4, 8, 16), locnet_width=2)
    rng = np.random.default_rng(0)
    batch = {'label': np.stack([make_heart_phantom((32,) * 3, seed=i)[0]
                                for i in range(2)]),
             'nii_affine': np.broadcast_to(np.diag([1.5, 1.5, 1.5, 1.0]), (2, 4, 4)),
             'view_affines': rotations(rng, 4, 0.1).cpu().numpy().reshape(2, 2, 4, 4)}
    out = {}
    for device in ('cpu', 'cuda'):
        unet, atms, _, _ = build_step(spec, device)
        b = {k: torch.tensor(np.array(v), device=device,
                             dtype=torch.int64 if k == 'label' else torch.float32)
             for k, v in batch.items()}
        with torch.no_grad():
            loss, aux = train.forward(spec, unet, atms, b)
        out[device] = (loss, aux, train.theta_pass(spec, atms, b),
                       train.eval_step(spec, unet, atms, b))
    log("small reference: float32 32^3 forward, theta_pass, eval_step, GPU vs CPU")
    chk = Checker()
    (lc, ac, tc, ec), (lg, ag, tg, eg) = out['cpu'], out['cuda']
    # float32 on both sides with TF32 off; the sums (convolutions, norms, the loss
    # over 6 x 32^3 voxels) run in another order on the GPU
    chk.compare('reference', 'loss', lg.cpu(), lc, 1e-4 * max(1.0, abs(lc.item())))
    chk.compare('reference', 'thetas', ag['thetas'].cpu(), ac['thetas'], 1e-4)
    chk.compare('reference', 'logits', ag['logits'].cpu(), ac['logits'], 1e-3, True)
    chk.compare('reference', 'theta_pass', tg.cpu(), tc, 1e-4)
    chk.compare('reference', 'eval_step loss', eg['loss'].cpu(), ec['loss'],
                1e-4 * max(1.0, abs(ec['loss'].item())))
    chk.compare('reference', 'eval_step b_input', eg['b_input'].cpu(), ec['b_input'], 1e-4)
    # the argmax may flip where two logits tie within the rounding difference
    flipped = (eg['pred'].cpu() != ec['pred']).float().mean().item()
    dice_err = np.nanmax(np.abs(eg['dice'].cpu().numpy() - ec['dice'].numpy()))
    log(f"  eval_step pred: {flipped:.3e} of voxels differ (tol 1e-3); dice max abs "
        f"diff {dice_err:.3e} (tol 1e-3)")
    if flipped > 1e-3 or not dice_err <= 1e-3:
        raise AssertionError(f"eval_step pred/dice disagree: {flipped}, {dice_err}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from acquisition_focus_tpu_torch.ops.kernels import _lib

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _lib.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_lib.NVCC_FLAGS)})")

    rng = np.random.default_rng(0)
    chk = Checker()
    check_volume_resample(chk, rng)
    check_plane_resample(chk, rng)
    check_conv3d(chk, rng)
    check_conv3d_grads(chk)
    torch.cuda.empty_cache()

    fwd = run_steps('fwd')
    full = run_steps('full')
    compare_modes(fwd, full)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        launches = run_sweep(Path(tmp))
    check_small_reference()

    sources = {
        'plane_resample_fwd': ('acquisition_focus_tpu_torch/csrc/plane_resample.cu',
                               'acquisition_focus_tpu/ops/pallas/plane_resample.py:363'),
        'plane_resample_bwd': ('acquisition_focus_tpu_torch/csrc/plane_resample.cu',
                               'acquisition_focus_tpu/ops/pallas/plane_resample.py:413'),
        'volume_resample': ('acquisition_focus_tpu_torch/csrc/volume_resample.cu',
                            'acquisition_focus_tpu/ops/pallas/volume_resample.py:299'),
        'conv3d_fwd': ('acquisition_focus_tpu_torch/csrc/conv3d.cu',
                       'acquisition_focus_tpu/ops/pallas/conv3d.py:143'),
        'conv3d_wgrad': ('acquisition_focus_tpu_torch/csrc/conv3d_wgrad.cu',
                         'acquisition_focus_tpu/ops/pallas/conv3d.py:248'),
    }
    kernels = [{'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
                'launches': launches[name],
                'max_abs_err': chk.rows[name]['max_abs_err'],
                'ms': chk.rows[name]['ms'], 'plain_ms': chk.rows[name]['plain_ms']}
               for name, (src, rep) in sources.items()]
    # K3 run as the conv's input gradient: its launches, error and times
    dx = chk.rows['conv3d_dx']
    kernels[3].update(dx_launches=launches['conv3d_dx'], dx_max_abs_err=dx['max_abs_err'],
                      dx_ms=dx['ms'], dx_plain_ms=dx['plain_ms'])
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
