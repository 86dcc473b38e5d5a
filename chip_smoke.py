#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``acquisition_focus_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

1. Device: the card's name and power limit, torch and CUDA versions; build the CUDA
   kernels from ``acquisition_focus_tpu_torch/csrc`` (nvcc, sm_90a) and time it. The
   SM clock, its maximum, temperature and power draw at the start, after the
   kernel checks and at the end.
2. Kernels at the main path's shapes: each kernel against its plain PyTorch
   version on the same CUDA tensors, in bfloat16 and float32 (TF32 off), with the
   error against a stated tolerance and both times (CUDA events, after warm-up):
   K1 forward/backward at all six skip-connector levels, for one view and as the
   main path launches them (three views into the decoder's concat buffer, its
   cotangent read in place; also into a NaN-filled buffer), and at level 0 on
   unrounded affines against the plain version in the kernel's coordinate
   arithmetic, K2 at the input of each path that launches it (the hybrid-unet
   sweep's, the (E)Pix2Vox sweep's, and the from-segmented sweep's 32^3 prescan at
   6 mm from the 128^3 volume, a shrink by 4 per axis; and, as a reference only,
   ``F.grid_sample`` on a grid made beforehand), K3 forward, K3 as the
   conv's input gradient, and K4 (the conv's weight gradient). The from-segmented
   sweep's own shapes are held too, in rows of their own: K1 with two views at the
   six levels, and K3, K3 as dx and K4 at its full-resolution decoder convs
   (64 -> 32 and 32 -> 32).
   (E)Pix2Vox's 128^3 tail (``ops/kernels/p2v_tail.py``, ``csrc/p2v_tail.cu``) at
   ``epix2vox.ref``'s shapes, against float64 (``check_p2v_tail``): each merger
   block's fused forward, input gradient, weight and bias gradients and its
   norm's backward at (2, Ci, 128^3), the last activation, the ordered sums, and
   up5's weight gradient at (2, 32, 64^3), timed against the parent's library
   calls with cuDNN's TF32 on.
3. The training step: the default configuration's step
   (``spec_from_config(DEFAULTS, 6, 3)``: hybrid U-Net at reference widths, 3 views,
   6 classes, 128^3 @ 192 mm, batch 2 x accum 2, bf16) on phantom labels, random
   weights from a seed: 1 warm-up and 3 timed steps with ``use_pallas_conv3d='fwd'``
   (K1, K2, K3 forward; K1f and K1b must launch once per skip level and
   microbatch), then the same 4 steps from the same weights, batch and
   generator seed with ``'full'`` (K3 also as the input gradient, K4 as the weight
   gradient). Step 0's loss must agree between the two.
   Then the recompute settings (``atm_remat``, ``unet_remat``, both,
   ``decoder_save_names`` ('conv_out',) and ('conv_out', 'conv_in'), against the
   default policy) on the same step under ``'fwd'``: the first microbatch's
   gradients against the default's (and the default's against a second run of
   itself) within RECOMPUTE_GRAD_TOL of each leaf's largest magnitude; 1 warm-up
   and 3 timed steps each: s/step, peak memory, launches per step (the default
   policy must launch K3 4, K1f and K1b 12 and K2 2 times a step, as with no
   recompute), step 0's loss within 1e-6 (rel.) of the default's; the peak under
   both remats below the default policy's, and that below the save-all step's.
   Then one step at batch 8 x accum 1 under both remats.
4. The dataset build: N_CASES (8) phantom cases written as NIfTI files at 128^3, 1.5 mm,
   built by ``load_or_build`` on the card (seconds per case); the 2 test cases
   built again on the CPU with the card's centroid affines injected: labels equal
   (at most ``BUILD_CASE_TOL`` of the voxels differ), view and input affines and
   images within 1e-3; the two centroid fits' difference printed, not gated.
5. The sweep through the CLI: ``main.main(['--meta_config_path', meta])`` builds
   the dataset from those files on the card and runs ``stage_sweep_run`` ->
   ``run_dl`` at full width (the same configuration under ``'full'`` with
   ``theta_refresh_every=2``, 2 epochs per stage, fold 0, all four stages
   ``opt_view0..2`` and ``ref``) on the build's p2CH view planes: locnet epoch,
   ``theta_pass``, cached-theta epoch, ``eval_step``, device surface metrics,
   checkpoints and their chaining. Every kernel must have launched during the CLI
   run; frozen views' ATMs must stay bit-equal. Per stage it prints what the run
   wrote (sweep state, ``metrics.jsonl``); then it times the runner's calls apart
   once: a locnet and a cached-theta step, the heavy metrics, a checkpoint load
   and save.
6. The (E)Pix2Vox sweep through the CLI on the same files: a meta config like
   ``config_dict_id21.json`` (hybrid-EPix2Vox, p2CH + p4CH, binarized) at batch 1
   x accum 4, 2 epochs per stage, opt_view0, opt_view1 and ref, read back as in 5;
   K2 and the 128^3 tail's kernels (``p2v_*``) must launch. Then (E)Pix2Vox steps at that
   shape, timed with cuDNN's TF32 on and off, and one hybrid-Pix2Vox step; and an
   EPix2VoxModel128 forward on the GPU (float32, TF32 off) against the CPU's.
7. From-segmented, on the same files: the segmenter trained by
   ``scripts/train_segmenter.py`` at full width (128^2, batch 8, ``--multires``,
   SEG_STEPS steps; s/step and final loss); the from-segmented build of the 2 test
   cases with ``config_dict_id13.json``'s 32^3 @ 192 mm prescan (per-case prescan
   Dice and HD95, seconds per case; the build gate lowered explicitly, FS_GATE); a
   CLI sweep like ``config_dict_id13.json`` (axial + coronal, opt_view0, opt_view1,
   ref; 2 epochs per stage, ``'full'``), in which K1f, K1b, K2, K3 and K4 must all
   launch; a float32 from-segmented ``eval_step`` at 32^2 slices
   (``config_dict_id14.json``'s shape) and ``slice_min_principal_align_affines`` on
   the GPU against the CPU.
8. A small float32 configuration on the GPU held against the same forward,
   ``theta_pass`` and ``eval_step`` on the CPU, where every wrapper takes its plain
   version.
8b. The device mesh (``parallel/``): K3, K3 as dx and K4 at the shapes a 'model'
   axis gives the 128^3 decoder convs (Ci 96 / 48 -> Co 24 and 12), in rows of
   their own (``<kernel> mesh``), in the kernel phase; then ``run_dl`` at full
   width (one epoch, ``'full'``, the build's cases, fold 0) without a mesh, and in
   an NCCL process group of one rank on {'data': 1} and on {'model': 1} (every
   collective at world size 1, every U-Net module its sharded stand-in): the
   logged losses and scores and the epoch's checkpoint (parameters, both
   optimizers' states) bit-equal to the unmeshed run's; every kernel must launch
   in the mesh runs. The same three runs of (E)Pix2Vox (``config_dict_id21.json``'s
   model keys: hybrid-EPix2Vox, p2CH + p4CH, binarized labels; the opt-all
   localization nets; TF32 on, cuDNN's deterministic algorithms): bit-equal, K2
   launching (its counts are their own path, ``epix2vox_mesh_world_of_one``);
   {'data': 1} runs the 128^3 tail's kernels as the unmeshed run does, while
   {'model': 1}'s stand-ins keep the library's path, so it is held against a
   fourth, unmeshed run with the tail on the library's path.
   With two or more cards it also runs ``scripts/smoke_mesh``'s
   gradient checks on the meshes that fit (the four-card proof is ``python3 -m
   acquisition_focus_tpu_torch.scripts.smoke_mesh``). The phase prints which.
8c. The orbax import: whether ``tensorstore`` imports on this machine, and one
   float32 ``train_step`` from ``tests/torch_data/orbax_run.pt`` (the port's file
   that ``scripts/import_orbax.py`` wrote from a JAX ``run_dl`` pause of a tiny
   spec): its loss within 1e-4 (rel.) of the JAX package's, committed beside it.
9. The last line is {"ok": true, "device": {...}}; the line before it lists the
   kernels as JSON: launches during the CLI run (``launches``; per path in
   ``launches_by_path``: the hybrid-unet sweep, the (E)Pix2Vox sweep, the
   from-segmented sweep, and the mesh phase's world-of-one runs of the hybrid
   U-Net and of (E)Pix2Vox; the tail's rows (``p2v_*``, ``replaces`` null: no TPU
   kernel) sum the five merger blocks' checks; K2's row also holds ``prescan32``,
   its check at the from-segmented prescan shape, and the rows of K1, K3 and K4 ``from_segmented``,
   their checks at that sweep's two-view shapes; ``max_abs_err`` is the largest
   over all of a kernel's shapes) and per
   training step of each mode
   (``launches_per_step``), the largest error against the plain version, the bf16
   kernel and plain times summed over the main path's shapes (K1: three views per
   launch; ``one_view_*``: the one-view launches), the least time the card
   could take for the same work (``bound_ms``: each input read and each output
   written once at 3.35 TB/s, or the operations at the peak rate of their type,
   whichever is larger; ``bound_by`` says which; K1b counts the cotangent only at
   the band voxels it needs, and ``dense_bound_ms`` counts all of it) and,
   for the three conv uses, the one PyTorch call that computes the same function
   (``library_ms``: ``F.conv3d``, ``conv3d_input``, ``conv3d_weight``; null for
   K1 and K2, which no single call computes). Any failure raises and exits
   non-zero.
"""

import contextlib
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
STEPS = 4                   # training steps per mode, the first a warm-up
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
BF16_FLOP_S = 989e12        # dense bf16 tensor-core peak
F32_FLOP_S = 67e12          # float32 peak outside the tensor cores


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


def rotations(rng, n, offset, dyadic=False):
    """(n, 4, 4) random proper rotations with offsets in [-offset, offset];
    ``dyadic``: entries rounded to multiples of 2^-6."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out[i, :3, :3] = q
        out[i, :3, 3] = rng.uniform(-offset, offset, 3)
    if dyadic:
        out = np.round(out * 64) / 64
    return torch.tensor(out, dtype=torch.float32, device='cuda')


def bound(nbytes, flops, peak):
    """(ms, 'bytes' or 'operations'): the least time for moving ``nbytes`` once and
    doing ``flops`` at ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def conv_flops(x_shape, co):
    """2 B D H W 27 Ci Co: the 3^3 conv's multiply-adds, whichever GEMM it is."""
    B, ci, D, H, W = x_shape
    return 2 * B * D * H * W * 27 * ci * co


class Checker:
    """Collects each kernel's comparison with its plain version, its times and
    its bound."""

    def __init__(self):
        self.rows = {}

    def add_bound(self, kernel, nbytes, flops, peak, row=None):
        """Add one checked shape's bound to the kernel's (summed like its times;
        ``row``: under another row than the kernel's)."""
        ms, by = bound(nbytes, flops, peak)
        row = self.rows.setdefault(row or kernel, {'max_abs_err': 0.0})
        row['bound_ms'] = row.get('bound_ms', 0.0) + ms
        row['bound_by'] = by
        return ms

    def compare(self, kernel, what, got, ref, tol, normalize=False, row=None):
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
        row = self.rows.setdefault(row or kernel, {'max_abs_err': 0.0})
        row['max_abs_err'] = max(row['max_abs_err'], err)
        return err

    def timed(self, kernel, what, kernel_fn, plain_fn, iters, main=False, library=False,
              row=None):
        """Time the kernel and its plain version in turns (plain, kernel, kernel,
        plain; the mean of each pair). ``main``: add the times to the kernel's row
        (or to ``row``). ``library``: the plain version is one PyTorch call
        computing the same function, also reported as library_ms."""
        p0, k0 = cuda_ms(plain_fn, iters), cuda_ms(kernel_fn, iters)
        k1, p1 = cuda_ms(kernel_fn, iters), cuda_ms(plain_fn, iters)
        ms, plain_ms = (k0 + k1) / 2, (p0 + p1) / 2
        log(f"  {kernel:20s} {what:30s} kernel {ms:.4f} ms ({k0:.4f}, {k1:.4f})  plain "
            f"{plain_ms:.4f} ms ({p0:.4f}, {p1:.4f})")
        if main:
            row = self.rows.setdefault(row or kernel, {'max_abs_err': 0.0})
            row['ms'] = row.get('ms', 0.0) + ms
            row['plain_ms'] = row.get('plain_ms', 0.0) + plain_ms
            if library:
                row['library_ms'] = row.get('library_ms', 0.0) + plain_ms
        return ms


def check_volume_resample(chk, rng):
    """K2 at the prescan resample of each path that launches it: the hybrid-unet
    sweep's (2, 6, 128^3) label volume with 6 affines (3 views x 2 samples), and
    the (E)Pix2Vox sweep's (1, 2, 128^3) binarized volume with 2 affines (2 views
    x 1 sample; 2 channels, which the kernel pads to 8); 128^3 out."""
    import torch.nn.functional as F
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
        ms = chk.timed('volume_resample', name,
                       lambda: volume_resample_cuda(vol, theta, out),
                       lambda: grid_sample(vol, theta, out), 10,
                       main=dtype == torch.bfloat16)
        if dtype == torch.bfloat16:
            # the nearest library call, as a reference only: not the same function
            # (its floor has no 2^-14 nudge; it takes a grid made beforehand and one
            # volume per affine), so library_ms stays null
            vol_t = vol[torch.arange(theta.shape[0], device='cuda') % vol.shape[0]]
            grid = F.affine_grid(theta[:, :3], (theta.shape[0], 6) + out,
                                 align_corners=False).to(dtype)

            def library():
                return F.grid_sample(vol_t, grid, mode='bilinear', padding_mode='zeros',
                                     align_corners=False)

            lib_ms = (cuda_ms(library, 10) + cuda_ms(library, 10)) / 2
            diff = (library().float() - got.float()).abs().max().item()
            log(f"  {'volume_resample':20s} {'F.grid_sample (reference)':30s} {lib_ms:.4f} ms "
                f"(kernel {ms:.4f} ms), max |diff| {diff:.3e}: not the same function")
            del vol_t, grid
            # per output voxel: its sample point (~30 operations), then 8 weights
            # and 7 adds per channel
            n_vox = got.shape[0] * math.prod(out)
            chk.add_bound('volume_resample', vol.numel() * 2 + got.numel() * 2,
                          n_vox * (30 + 15 * got.shape[1]), F32_FLOP_S)
        del vol, got, ref
    log("K2 volume_resample, the (E)Pix2Vox sweep's input: (1, 2, 128^3) -> (2, 2, 128^3)")
    theta = rotations(np.random.default_rng(1), 2, 0.1)    # its own draws: the
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):   # rest keep theirs
        vol = torch.rand((1, 2) + out, device='cuda').to(dtype)
        got = volume_resample_cuda(vol, theta, out)
        ref = grid_sample(vol, theta, out)
        name = str(dtype).split('.')[-1]
        chk.compare('volume_resample', f'{name} out (E)Pix2Vox B1 C2 x2', got, ref, tol)
        chk.timed('volume_resample', f'{name} (E)Pix2Vox B1 C2 x2',
                  lambda: volume_resample_cuda(vol, theta, out),
                  lambda: grid_sample(vol, theta, out), 10)
        del vol, got, ref


PRESCAN32 = 'volume_resample prescan 32^3'     # K2's row at the from-segmented shape


def check_volume_resample_prescan32(chk, rng):
    """K2 at the from-segmented sweep's prescan resample (``config_dict_id13.json``'s
    32^3 prescan at 192 mm from the 128^3 hires volume at 1.5 mm: a shrink by 4 per
    axis, 64 source voxels per output voxel, of which the trilinear gather reads
    8): the (2, 6, 128^3) label volume, 4 affines (2 views x 2 samples), 32^3 out,
    in bf16 (1e-2) and float32 (1e-4) against the plain version. Its times and
    bound go to their own row. The bound counts the input at most once and at most
    at the 8 corners of every output voxel (two output volumes per input volume:
    a quarter of its voxels)."""
    from acquisition_focus_tpu_torch.ops.kernels.volume_resample import (
        volume_resample_cuda)
    from acquisition_focus_tpu_torch.ops.resample import grid_sample
    log("K2 volume_resample at the from-segmented prescan: (2, 6, 128^3) -> (4, 6, 32^3)")
    out = (32, 32, 32)
    theta = rotations(rng, 4, 0.1)
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        vol = torch.rand((2, 6, 128, 128, 128), device='cuda').to(dtype)
        got = volume_resample_cuda(vol, theta, out)
        ref = grid_sample(vol, theta, out)
        name = str(dtype).split('.')[-1]
        chk.compare(PRESCAN32, f'{name} out', got, ref, tol)
        chk.timed(PRESCAN32, name, lambda: volume_resample_cuda(vol, theta, out),
                  lambda: grid_sample(vol, theta, out), 20, main=dtype == torch.bfloat16)
        if dtype == torch.bfloat16:
            n_vox = got.shape[0] * math.prod(out)
            read = min(vol.numel(), 8 * n_vox * vol.shape[1])
            chk.add_bound(PRESCAN32, read * 2 + got.numel() * 2,
                          n_vox * (30 + 15 * got.shape[1]), F32_FLOP_S)
        del vol, got, ref
    torch.cuda.empty_cache()


SKIP_LEVELS = ((128, 16), (64, 32), (32, 64), (16, 128), (8, 256), (4, 256))
# the rows of K1's one-view launches, kept beside the main path's three-view rows
ONE_VIEW = {k: f'{k} one view' for k in ('plane_resample_fwd', 'plane_resample_bwd')}


def band_voxels(coefs, S):
    """Voxels of the (B, S^3) output with a non-zero plane weight max(0, 1 - |ix -
    S/2|) and a tap on the plane (nudged cell in -1..S-1 on both plane axes), from
    the (B, 3, 4) coefficients: the cotangent values K1b has to read."""
    r = torch.arange(S, dtype=torch.float32, device=coefs.device)

    def coord(row):
        c = coefs[:, row, :, None, None, None]
        return c[:, 0] + c[:, 1] * r[:, None, None] + c[:, 2] * r[None, :, None] + c[:, 3] * r

    cell_y, cell_z = (torch.floor(coord(i) + 2.0 ** -14) for i in (1, 2))
    keep = ((coord(0) - S // 2).abs() <= 1) & (cell_y >= -1) & (cell_y <= S - 1) \
        & (cell_z >= -1) & (cell_z <= S - 1)
    return int(keep.sum())


def check_plane_resample(chk, rng):
    """K1 forward and backward at the six skip-connector levels of the main path
    ((S, C) in SKIP_LEVELS), batch 2, for one view (``plane_resample``; its times
    and bounds go to the rows '<kernel> one view', comparable with earlier runs)
    and, in check_skip_concat, for the main path's launches: three views into the
    decoder's concat buffer (the kernels' rows); tolerances on errors divided by the
    reference's max. The kernel maps output voxels to plane coordinates through the
    (B, 3, 4) coefficient form, the plain version through normalized coordinates: in
    float32 the two round differently by ~1e-5 voxel at S = 128, hence 2e-4
    (forward). Here the affines' entries are multiples of 2^-6, so both coordinate
    forms are exact and take the same branch at every kink of the gradient (plane
    weight's sign and edge, cell boundaries, clamp band);
    check_plane_resample_unrounded holds level 0 on unrounded affines. K1b's bound
    counts the cotangent only at the band voxels (plane weight > 0), counted from
    this run's coefficients, which is all a kernel that skips the rest must read;
    the dense bound (the whole cotangent) is printed beside it and kept as
    dense_bound_ms."""
    from acquisition_focus_tpu_torch.ops.kernels import affine_coefficients
    from acquisition_focus_tpu_torch.ops.kernels.plane_resample import (
        plane_resample, plane_resample_bwd, plane_resample_fwd)
    from acquisition_focus_tpu_torch.ops.resample import sample_slice_into_volume
    for S, C in SKIP_LEVELS:
        log(f"K1 plane_resample: (2, {C}, {S}, {S}) -> (2, {C}, {S}^3)")
        theta = rotations(rng, 2, 0.2, dyadic=True)
        coefs = affine_coefficients(theta, (S,) * 3, (S,) * 3).contiguous()
        for dtype, tol_f, tol_b in ((torch.bfloat16, 1e-2, 3e-2),
                                    (torch.float32, 2e-4, 1e-3)):
            name = f"{str(dtype).split('.')[-1]} S{S} C{C}"
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
            if main:
                # per output voxel: its plane coordinates (~20 operations), then per
                # channel a bilinear tap forward (7) and its adjoint backward (~20)
                el = slices.element_size()
                n_vox, band = 2 * S ** 3, band_voxels(coefs, S)
                plane_bytes = slices.numel() * el + slices.numel() * 4
                chk.add_bound('plane_resample_fwd', slices.numel() * el + g.numel() * el,
                              n_vox * (20 + 7 * C), F32_FLOP_S, ONE_VIEW['plane_resample_fwd'])
                b_ms = chk.add_bound('plane_resample_bwd', band * C * el + plane_bytes,
                                     band * (20 + 20 * C), F32_FLOP_S,
                                     ONE_VIEW['plane_resample_bwd'])
                dense_ms, _ = bound(g.numel() * el + 2 * slices.numel() * el,
                                    n_vox * (20 + 20 * C), F32_FLOP_S)
                log(f"  plane_resample_bwd   {name:30s} band voxels {band} of {n_vox} "
                    f"({100 * band / n_vox:.2f}%): band bound {b_ms:.4f} ms, dense bound "
                    f"{dense_ms:.4f} ms")
            with torch.no_grad():
                chk.timed('plane_resample_fwd', name,
                          lambda: plane_resample_fwd(slices, coefs, S),
                          lambda: sample_slice_into_volume(slices, theta, S),
                          iters, main, row=ONE_VIEW['plane_resample_fwd'])
            s = slices.clone().requires_grad_()
            t = theta.clone().requires_grad_()
            out_graph = sample_slice_into_volume(s, t, S)
            chk.timed('plane_resample_bwd', name,
                      lambda: plane_resample_bwd(slices, coefs, g),
                      lambda: torch.autograd.grad(out_graph, (s, t), g,
                                                  retain_graph=True),
                      iters, main, row=ONE_VIEW['plane_resample_bwd'])
            del slices, g, out_k, out_p, ds_k, ds_p, out_graph, s, t
            check_skip_concat(chk, rng, S, C, dtype, tol_f, tol_b, iters, main)
            torch.cuda.empty_cache()


def check_skip_concat(chk, rng, S, C, dtype, tol_f, tol_b, iters, main, V=3, suffix=''):
    """The main path's K1 launches at one level: ``skip_concat(y, slices, theta)``,
    the decoder's concat of y (2, VC, S^3) and the V views' re-embedded planes
    (2, VC, S, S), one K1f launch into the buffer and one K1b launch reading its
    cotangent in place, against the plain composition (``sample_slice_into_volume``
    per view, ``torch.cat``): the buffer and the gradients to y, the slices and
    theta (affines rounded as in check_plane_resample). Then K1f into a NaN-filled
    buffer at channel VC: no NaN may remain in the views' channels, and channels
    [:VC] must stay NaN. The two launches are timed against their plain versions
    into the same buffer; the bound counts the V views' output and planes (K1f)
    and their band voxels (K1b). Rows: the kernel's name + ``suffix``."""
    from acquisition_focus_tpu_torch.ops.kernels import affine_coefficients
    from acquisition_focus_tpu_torch.ops.kernels.plane_resample import (
        plane_resample_bwd, plane_resample_fwd, skip_concat)
    from acquisition_focus_tpu_torch.ops.resample import sample_slice_into_volume
    co = V * C
    name = f"{str(dtype).split('.')[-1]} S{S} C{C} {V} views"
    kf, kb = 'plane_resample_fwd', 'plane_resample_bwd'
    rf, rb = kf + suffix, kb + suffix
    theta = rotations(rng, V * 2, 0.2, dyadic=True).reshape(V, 2, 4, 4)
    coefs = affine_coefficients(theta.reshape(-1, 4, 4), (S,) * 3, (S,) * 3)
    coefs = coefs.reshape(V, 2, 3, 4).contiguous()
    slices = torch.randn((2, V * C, S, S), device='cuda').to(dtype)
    y = torch.randn((2, co) + (S,) * 3, device='cuda').to(dtype)
    g = torch.randn((2, co + V * C) + (S,) * 3, device='cuda').to(dtype)

    def views(s, t):
        return [sample_slice_into_volume(s[:, v * C:(v + 1) * C], t[v], S) for v in range(V)]

    def grads(fn):
        args = [a.clone().requires_grad_() for a in (y, slices, theta)]
        out = fn(*args)
        return (out.detach(),) + torch.autograd.grad(out, args, g)

    got = grads(skip_concat)
    ref = grads(lambda a, s, t: torch.cat([a] + views(s, t), dim=1))
    for i, (what, tol) in enumerate((('out', tol_f), ('d_y', tol_f), ('d_slices', tol_b),
                                     ('d_theta', tol_b))):
        chk.compare(kf if i == 0 else kb, f'{name} {what}', got[i], ref[i], tol, True,
                    rf if i == 0 else rb)
    buf = torch.full(g.shape, float('nan'), dtype=dtype, device='cuda')
    plane_resample_fwd(slices, coefs, S, buf, co)
    n_nan, kept = buf[:, co:].isnan().sum().item(), buf[:, :co].isnan().all().item()
    log(f"  plane_resample_fwd   {name + ' into NaNs':30s} NaN left in the views' channels: "
        f"{n_nan}; channels [:{co}] untouched: {kept}  {'ok' if kept and not n_nan else 'FAIL'}")
    if n_nan or not kept:
        raise AssertionError(f"plane_resample_fwd {name}: {n_nan} voxels left unwritten, "
                             f"other channels untouched: {kept}")
    chk.compare(kf, f'{name} into NaNs', buf[:, co:], ref[0][:, co:], tol_f, True, rf)
    del got, ref

    def plain_fwd():
        for v, vol in enumerate(views(slices, theta)):
            buf[:, co + v * C:co + (v + 1) * C] = vol

    with torch.no_grad():
        chk.timed(kf, name, lambda: plane_resample_fwd(slices, coefs, S, buf, co),
                  plain_fwd, iters, main, row=rf)
    s, t = slices.clone().requires_grad_(), theta.clone().requires_grad_()
    out_graph = torch.cat([y] + views(s, t), dim=1)
    chk.timed(kb, name, lambda: plane_resample_bwd(slices, coefs, g, co),
              lambda: torch.autograd.grad(out_graph, (s, t), g, retain_graph=True),
              iters, main, row=rb)
    if main:
        el, n_vox = slices.element_size(), V * 2 * S ** 3
        band = sum(band_voxels(coefs[v], S) for v in range(V))
        chk.add_bound(kf, slices.numel() * el + n_vox * C * el,
                      n_vox * (20 + 7 * C), F32_FLOP_S, rf)
        chk.add_bound(kb, band * C * el + slices.numel() * (el + 4),
                      band * (20 + 20 * C), F32_FLOP_S, rb)
        dense_ms, _ = bound(n_vox * C * el + 2 * slices.numel() * el,
                            n_vox * (20 + 20 * C), F32_FLOP_S)
        row = chk.rows[rb]
        row['dense_bound_ms'] = row.get('dense_bound_ms', 0.0) + dense_ms


def check_plane_resample_unrounded(chk, rng):
    """K1 at level 0 (S 128, C 16, batch 2) on unrounded rotations, as the main
    path's learned affines are. There normalized coordinates and the kernels'
    coefficient form round ~1e-5 voxel apart, which can put a voxel on the other
    side of a kink of the gradient, so the kernel is held against the plain version
    in its own coordinate arithmetic (``sample_slice_into_volume_from_coefs``): on a
    plane of ones the float32 forward must be bit-equal (the same coordinates), and
    out, d_slices and d_theta within the tolerances of check_plane_resample. The
    gaps of the kernel and of that plain version to the normalized one are printed
    beside, not held."""
    from acquisition_focus_tpu_torch.ops.kernels import affine_coefficients
    from acquisition_focus_tpu_torch.ops.kernels.plane_resample import plane_resample
    from acquisition_focus_tpu_torch.ops.resample import (
        sample_slice_into_volume, sample_slice_into_volume_from_coefs)
    S, C = SKIP_LEVELS[0]
    log(f"K1 plane_resample, unrounded affines: (2, {C}, {S}, {S}) -> (2, {C}, {S}^3)")
    theta = rotations(rng, 2, 0.2)

    def from_coefs(s, t, S):
        return sample_slice_into_volume_from_coefs(
            s, affine_coefficients(t, (S,) * 3, (S,) * 3), S)

    ones = torch.ones((2, 1, S, S), device='cuda')
    n_diff = (plane_resample(ones, theta, S) != from_coefs(ones, theta, S)).sum().item()
    log(f"  plane_resample_fwd   {'float32 ones plane':30s} voxels that differ from the "
        f"coefficient form: {n_diff}  {'FAIL' if n_diff else 'ok'}")
    if n_diff:
        raise AssertionError(f"plane_resample_fwd: {n_diff} voxels of a ones plane "
                             "differ from the coefficient form")
    for dtype, tol_f, tol_b in ((torch.bfloat16, 1e-2, 3e-2), (torch.float32, 2e-4, 1e-3)):
        name = f"{str(dtype).split('.')[-1]} S{S} C{C} unrounded"
        slices = torch.randn((2, C, S, S), device='cuda').to(dtype)
        g = torch.randn((2, C, S, S, S), device='cuda').to(dtype)
        res = []
        for fn in (plane_resample, from_coefs, sample_slice_into_volume):
            s = slices.clone().requires_grad_()
            t = theta.clone().requires_grad_()
            out = fn(s, t, S)
            res.append((out.detach(),) + torch.autograd.grad(out, (s, t), g))
        kern, coef, norm = res
        for i, (what, tol) in enumerate((('out', tol_f), ('d_slices', tol_b),
                                         ('d_theta', tol_b))):
            kernel = 'plane_resample_fwd' if i == 0 else 'plane_resample_bwd'
            chk.compare(kernel, f'{name} {what}', kern[i], coef[i], tol, True)
            gaps = [((a[i].float() - norm[i].float()).abs().max()
                     / norm[i].float().abs().max()).item() for a in (kern, coef)]
            log(f"  {kernel:20s} {name + ' ' + what:30s} against the normalized "
                f"plain version: kernel {gaps[0]:.3e}, coefficient form {gaps[1]:.3e} "
                "(of its max; not held)")
        del slices, g, res, kern, coef, norm
    torch.cuda.empty_cache()


def report_conv(chk, kernel, name, ms, x_shape, co, nbytes, row=None):
    """Add a conv use's bound (its operations at the bf16 peak, or its bytes) and
    print its rate and share of that bound."""
    flops = conv_flops(x_shape, co)
    b_ms = chk.add_bound(kernel, nbytes, flops, BF16_FLOP_S, row)
    log(f"  {kernel:20s} {name:30s} {flops / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms "
        f"({chk.rows[row or kernel]['bound_by']}), {100 * b_ms / ms:.1f}% of the bound")


# the decoder's full-resolution convs (Ci, Co): three views at reference widths
# (the default step), and the from-segmented configs' two views
CONVS_3V = ((96, 48), (48, 48))
CONVS_2V = ((64, 32), (32, 32))


def check_conv3d(chk, rng, convs=CONVS_3V, suffix=''):
    """K3 at the decoder's full-resolution convs ``convs``: (2, Ci, 128^3) -> Co;
    the kernel's time includes the wrapper's weight layout conversion and its
    channels-last staging of x. Tolerances on errors divided by the reference's
    max. Rows: the kernel's name + ``suffix``."""
    import torch.nn.functional as F
    from acquisition_focus_tpu_torch.ops.kernels.conv3d import conv3d
    row = 'conv3d_fwd' + suffix
    for ci, co in convs:
        log(f"K3 conv3d: (2, {ci}, 128^3) -> {co}")
        w = torch.randn((co, ci, 3, 3, 3), device='cuda') / (27 * ci) ** 0.5
        b = torch.randn((co,), device='cuda') * 0.1
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            name = f"{str(dtype).split('.')[-1]} Ci{ci} Co{co}"
            x = torch.randn((2, ci, 128, 128, 128), device='cuda').to(dtype)
            with torch.no_grad():
                got = conv3d(x, w, b)
                ref = F.conv3d(x, w.to(dtype), b.to(dtype), padding=1)
                chk.compare('conv3d_fwd', f'{name} out', got, ref, tol, True, row)
                del got, ref
                ms = chk.timed('conv3d_fwd', name, lambda: conv3d(x, w, b),
                               lambda: F.conv3d(x, w.to(dtype), b.to(dtype), padding=1),
                               3, main=dtype == torch.bfloat16, library=True, row=row)
                if dtype == torch.bfloat16:
                    report_conv(chk, 'conv3d_fwd', name, ms, x.shape, co,
                                2 * (x.numel() + 2 * co * 128 ** 3) + w.numel() * 2, row)
            del x


def check_conv3d_grads(chk, convs=CONVS_3V, suffix=''):
    """K3 as the input gradient and K4 at the decoder's full-resolution convs
    ``convs``: x (2, Ci, 128^3), cotangent (2, Co, 128^3). The gradients come from
    ``torch.autograd.grad`` through ``conv3d(x, w, b, kernel_dx=True,
    kernel_dw=True)``, the main path's backward (its weight flip and its guards),
    with float32 weights as the model holds them. Each is held against the
    library's gradient in float32 (TF32 off) on the same inputs, so the bf16 check
    sees the kernel's own error and not the library's bf16 rounding; errors divided
    by the reference's max. Tolerances against what the kernels measured on an NVIDIA
    H100 at 700 W: K4 5e-4 (bf16, measured up to 9.1e-05) and 5e-5 (f32, 5.4e-06),
    K3-as-dx 1e-2 (bf16, one bf16 rounding of the output: up to 3.7e-03) and 1e-4
    (f32, 2.2e-06). Times are of the kernels' direct launches against the library
    in the same dtype (the gradients the 'fwd' mode takes), which is also each
    row's library_ms. Rows: the kernel's name + ``suffix``."""
    from acquisition_focus_tpu_torch.ops.kernels.conv3d import (
        conv3d, conv3d_fwd_cuda, conv3d_wgrad_cuda)
    grad_input, grad_weight = torch.nn.grad.conv3d_input, torch.nn.grad.conv3d_weight
    r_dx, r_dw = 'conv3d_dx' + suffix, 'conv3d_wgrad' + suffix
    for ci, co in convs:
        log(f"K3 as dx, K4 wgrad: x (2, {ci}, 128^3), cotangent (2, {co}, 128^3)")
        w_shape = (co, ci, 3, 3, 3)
        w32 = torch.randn(w_shape, device='cuda') / (27 * ci) ** 0.5
        b32 = torch.zeros(co, device='cuda')
        for dtype, tol_dx, tol_dw in ((torch.bfloat16, 1e-2, 5e-4),
                                      (torch.float32, 1e-4, 5e-5)):
            name = f"{str(dtype).split('.')[-1]} Ci{ci} Co{co}"
            main = dtype == torch.bfloat16
            x = torch.randn((2, ci, 128, 128, 128), device='cuda').to(dtype)
            g = torch.randn((2, co, 128, 128, 128), device='cuda').to(dtype)
            w = w32.to(dtype)
            xg, wg = x.clone().requires_grad_(), w32.clone().requires_grad_()
            dx, dw = torch.autograd.grad(conv3d(xg, wg, b32, True, True), (xg, wg), g)
            del xg, wg
            chk.compare('conv3d_dx', f'{name} dx', dx,
                        grad_input(x.shape, w.float(), g.float(), padding=1), tol_dx, True,
                        r_dx)
            chk.compare('conv3d_wgrad', f'{name} dw', dw,
                        grad_weight(x.float(), w_shape, g.float(), padding=1), tol_dw, True,
                        r_dw)
            del dx, dw
            zb = torch.zeros(ci, device='cuda')
            w_t = w.flip(2, 3, 4).transpose(0, 1)
            ms_dx = chk.timed('conv3d_dx', name,
                              lambda: conv3d_fwd_cuda(g, w_t, zb, 'conv3d_dx'),
                              lambda: grad_input(x.shape, w, g, padding=1), 3, main, True,
                              r_dx)
            ms_dw = chk.timed('conv3d_wgrad', name, lambda: conv3d_wgrad_cuda(x, g),
                              lambda: grad_weight(x, w_shape, g, padding=1), 3, main, True,
                              r_dw)
            if main:
                report_conv(chk, 'conv3d_dx', name, ms_dx, g.shape, ci,
                            2 * (g.numel() + x.numel()) + w.numel() * 2, r_dx)
                report_conv(chk, 'conv3d_wgrad', name, ms_dw, x.shape, co,
                            2 * (x.numel() + g.numel()) + 4 * w.numel(), r_dw)
            del x, g
            torch.cuda.empty_cache()


FS = ' from-segmented'      # suffix of the rows at the from-segmented sweep's shapes
FS_KERNELS = ('plane_resample_fwd', 'plane_resample_bwd', 'conv3d_fwd', 'conv3d_dx',
              'conv3d_wgrad')
MESH = ' mesh'              # suffix of the rows at the shapes a 'model' axis gives
MESH_KERNELS = ('conv3d_fwd', 'conv3d_dx', 'conv3d_wgrad')


def check_from_segmented_kernels(chk, rng):
    """The from-segmented sweep's own launch shapes (axial + coronal: the hybrid
    U-Net's features are two views x the base widths): K1 as that path launches it,
    two views into the decoder's concat buffer at the six levels, and K3, K3 as dx
    and K4 at its full-resolution decoder convs, 64 -> 32 and 32 -> 32, each against
    its plain version at the default shapes' tolerances, in the rows '<kernel>
    from-segmented' (K2 at that path's prescan: check_volume_resample_prescan32).
    K1 is timed with half the iterations of the default shapes."""
    for S, C in SKIP_LEVELS:
        log(f"K1 skip_concat, two views: (2, {2 * C}, {S}, {S}) -> (2, {4 * C}, {S}^3)")
        for dtype, tol_f, tol_b in ((torch.bfloat16, 1e-2, 3e-2),
                                    (torch.float32, 2e-4, 1e-3)):
            check_skip_concat(chk, rng, S, C, dtype, tol_f, tol_b, 10 if S < 64 else 5,
                              dtype == torch.bfloat16, V=2, suffix=FS)
            torch.cuda.empty_cache()
    check_conv3d(chk, rng, CONVS_2V, FS)
    check_conv3d_grads(chk, CONVS_2V, FS)
    torch.cuda.empty_cache()


# (E)Pix2Vox's 128^3 tail (ops/kernels/p2v_tail.py) at epix2vox.ref's shapes: the
# merger's blocks (Ci, Co) on the batch it runs at (2 samples, their views fused by
# the cross-view conv), and up5 (32 -> 8, 64^3 -> 128^3) on the decoder's 2 volumes
P2V_BLOCKS = ((9, 16), (16, 8), (8, 4), (4, 2), (2, 1))
P2V_N, P2V_S, P2V_SLOPE, P2V_EPS = 2, 128, 0.2, 1e-5
TF32_FLOP_S = 495e12        # dense TF32 tensor-core peak (the configuration's precision)


@contextlib.contextmanager
def cudnn_tf32():
    """cuDNN's TF32 on, as (E)Pix2Vox's configuration runs its library calls."""
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = flag


def check_p2v_tail(chk):
    """The 128^3 tail's kernels at ``epix2vox.ref``'s shapes, on card tensors, each
    held against its plain version run in float64 on the same inputs (errors over
    the reference's max, tolerance 1e-5: float32 rounding of sums over up to 432
    terms a voxel and 4M voxels a channel, where a wrong term or tile is 1e-2 or
    more). Per merger block (Ci -> Co, x (2, Ci, 128^3) taken as the previous
    block's pre-norm output, its statistics, a norm scale in [0.5, 1.5] and a
    shift ~ N(0, 0.3); the first block reads x as it is): ``block_forward``
    (``p2v_merge_fwd``: the previous norm and leaky-ReLU on load, y and y's
    statistics), ``block_input_grad`` (``p2v_merge_dx``), ``block_param_grads``
    (``p2v_merge_dw``: weight and bias gradients), ``norm_backward`` on y
    (``p2v_merge_norm``'s sums and apply; its leaky-ReLU branch taken from the
    kernels' own z, as ``norm_act`` gives it, since a z within float32 rounding of
    0 takes the other slope) and, for the last block, ``norm_act``; then
    ``up_weight_grad`` (``p2v_up_dw``) at (2, 32, 64^3). ``p2v_merge_sum``
    (float64 column sums) is timed alone on each block's partials; the other
    rows time the wrappers, their sums included. Library: the parent's calls for
    the same work in float32 with cuDNN's TF32 on, as the configuration runs
    them (norm + leaky-ReLU + ``F.conv3d``; ``conv3d_input``; the activation and
    ``conv3d_weight``; autograd's backward of ``F.batch_norm`` + leaky-ReLU; the
    transposed conv's weight gradient). Bound: the bytes, each input read and
    each output written once at float32, or the operations at the TF32 peak."""
    import torch.nn.functional as F
    from acquisition_focus_tpu_torch.ops.kernels import p2v_tail
    grad_input, grad_weight = torch.nn.grad.conv3d_input, torch.nn.grad.conv3d_weight
    gen = torch.Generator(device='cuda').manual_seed(7)
    N, S, slope, eps = P2V_N, P2V_S, P2V_SLOPE, P2V_EPS
    V = S ** 3
    dims = (0, 2, 3, 4)
    view = (1, -1, 1, 1, 1)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device='cuda')

    def stats64(y64):
        var, mean = torch.var_mean(y64, dims, correction=0)
        return torch.stack([mean, (var + eps).rsqrt()])

    def act64(x64, st, gamma, beta):
        sc = gamma.double() * st[1].double()
        return F.leaky_relu(x64 * sc.view(view) + (beta.double() - st[0].double() * sc).view(view),
                            slope)

    def lib_act(x, st, gamma, beta):
        return F.leaky_relu(F.batch_norm(x, None, None, gamma, beta, True, eps=eps), slope)

    for i, (ci, co) in enumerate(P2V_BLOCKS):
        name = f"block {i} Ci{ci} Co{co}"
        log(f"p2v tail, merger {name}: x ({N}, {ci}, {S}^3)")
        x = rand(N, ci, S, S, S)
        w, b = rand(co, ci, 3, 3, 3) / (27 * ci) ** 0.5, rand(co) * 0.1
        g = rand(N, co, S, S, S)
        x64 = x.double()
        if i:
            st_x = stats64(x64).float()
            gamma = torch.rand((ci,), generator=gen, device='cuda') + 0.5
            beta = rand(ci) * 0.3
            prev = (st_x, gamma, beta, slope)
            a64 = act64(x64, st_x, gamma, beta)
        else:
            prev, a64 = None, x64
        ops = 2 * N * V * 27 * ci * co
        wb = 4 * (w.numel() + co)

        y, st = p2v_tail.block_forward(x, prev, w, b, eps)
        y64 = F.conv3d(a64, w.double(), b.double(), padding=1)
        chk.compare('p2v_merge_fwd', f'{name} y', y, y64, 1e-5, True)
        st64 = stats64(y64)
        chk.compare('p2v_merge_fwd', f'{name} mean', st[0], st64[0], 1e-5, True)
        chk.compare('p2v_merge_fwd', f'{name} rstd', st[1], st64[1], 1e-5, True)
        del st64
        with cudnn_tf32():
            chk.timed('p2v_merge_fwd', name, lambda: p2v_tail.block_forward(x, prev, w, b, eps),
                      (lambda: F.conv3d(lib_act(x, *prev[:3]), w, b, padding=1)) if i else
                      (lambda: F.conv3d(x, w, b, padding=1)), 3, main=True, library=True)
        chk.add_bound('p2v_merge_fwd', 4 * N * V * (ci + co) + wb, ops, TF32_FLOP_S)

        dx = p2v_tail.block_input_grad(g, w, x.shape)
        chk.compare('p2v_merge_dx', f'{name} dx', dx,
                    grad_input(x.shape, w.double(), g.double(), padding=1), 1e-5, True)
        del dx
        with cudnn_tf32():
            chk.timed('p2v_merge_dx', name, lambda: p2v_tail.block_input_grad(g, w, x.shape),
                      lambda: grad_input(x.shape, w, g, padding=1), 3, main=True, library=True)
        chk.add_bound('p2v_merge_dx', 4 * N * V * (ci + co) + wb, ops, TF32_FLOP_S)

        dw, db = p2v_tail.block_param_grads(x, prev, g, w.shape)
        chk.compare('p2v_merge_dw', f'{name} dw', dw,
                    grad_weight(a64, w.shape, g.double(), padding=1), 1e-5, True)
        chk.compare('p2v_merge_dw', f'{name} db', db, g.double().sum(dims), 1e-5, True)
        del dw, db, a64
        with cudnn_tf32():
            chk.timed('p2v_merge_dw', name, lambda: p2v_tail.block_param_grads(x, prev, g, w.shape),
                      (lambda: (grad_weight(lib_act(x, *prev[:3]), w.shape, g, padding=1),
                                g.sum(dims))) if i else
                      (lambda: (grad_weight(x, w.shape, g, padding=1), g.sum(dims))),
                      3, main=True, library=True)
        chk.add_bound('p2v_merge_dw', 4 * N * V * (ci + co) + wb, ops, TF32_FLOP_S)
        del x, x64, g

        # the norm of this block's output y, with the statistics the kernel gave it
        gamma_y = torch.rand((co,), generator=gen, device='cuda') + 0.5
        beta_y = rand(co) * 0.3
        da = rand(N, co, S, S, S)
        mask = p2v_tail.norm_act(y, st, gamma_y, beta_y, slope) > 0
        mean, rstd = st[0].double().view(view), st[1].double().view(view)
        xhat = (y64 - mean) * rstd
        dz = torch.where(mask, da.double(), da.double() * slope)
        s1, s2 = dz.sum(dims), (dz * xhat).sum(dims)
        k = gamma_y.double().view(view) * rstd / (N * V)
        dy64 = k * (N * V * dz - s1.view(view) - xhat * s2.view(view))
        del dz, mask
        dy, dgamma, dbeta = p2v_tail.norm_backward(da, y, st, gamma_y, beta_y, slope)
        chk.compare('p2v_merge_norm', f'{name} backward dy', dy, dy64, 1e-5, True)
        chk.compare('p2v_merge_norm', f'{name} backward dgamma', dgamma, s2, 1e-5, True)
        chk.compare('p2v_merge_norm', f'{name} backward dbeta', dbeta, s1, 1e-5, True)
        del dy, dy64, xhat
        yr = y.clone().requires_grad_()
        gr, br = gamma_y.clone().requires_grad_(), beta_y.clone().requires_grad_()
        with cudnn_tf32():
            out = F.leaky_relu(F.batch_norm(yr, None, None, gr, br, True, eps=eps), slope)
            chk.timed('p2v_merge_norm', f'{name} backward',
                      lambda: p2v_tail.norm_backward(da, y, st, gamma_y, beta_y, slope),
                      lambda: torch.autograd.grad(out, (yr, gr, br), da, retain_graph=True),
                      3, main=True, library=True)
        del out, yr
        # reduce: y and da read; apply: y and da read, dy written
        chk.add_bound('p2v_merge_norm', 4 * N * V * co * 5, 0, TF32_FLOP_S)
        if i == len(P2V_BLOCKS) - 1:
            got = p2v_tail.norm_act(y, st, gamma_y, beta_y, slope)
            chk.compare('p2v_merge_norm', f'{name} activation', got,
                        act64(y64, st, gamma_y, beta_y), 1e-5, True)
            del got
            chk.timed('p2v_merge_norm', f'{name} activation',
                      lambda: p2v_tail.norm_act(y, st, gamma_y, beta_y, slope),
                      lambda: lib_act(y, st, gamma_y, beta_y), 3, main=True, library=True)
            chk.add_bound('p2v_merge_norm', 4 * N * V * co * 2, 0, TF32_FLOP_S)

        # p2v_merge_sum alone on this block's forward statistics' partials
        rows = p2v_tail._rows(p2v_tail._ROWS_FWD, N, ci, co, (S, S, S))
        part = rand(rows, 2 * co)
        got, _ = p2v_tail._sum(part, co, p2v_tail._SUM_STATS, count=N * V, out_rows=2, eps=eps)
        p64 = part.double().sum(0)
        m64 = p64[:co] / (N * V)
        chk.compare('p2v_merge_sum', f'{name} mean', got[0], m64, 1e-5, True)
        chk.timed('p2v_merge_sum', f'{name} stats ({rows} rows)',
                  lambda: p2v_tail._sum(part, co, p2v_tail._SUM_STATS, count=N * V, out_rows=2,
                                        eps=eps),
                  lambda: part.double().sum(0), 10, main=True)
        chk.add_bound('p2v_merge_sum', 4 * part.numel(), 0, TF32_FLOP_S)
        del y, y64, da, part
        torch.cuda.empty_cache()

    ci, co = p2v_tail.UP_KERNEL_SHAPE[:2]
    Su = S // 2
    log(f"p2v tail, up5: x ({N}, {ci}, {Su}^3), cotangent ({N}, {co}, {S}^3)")
    x, g = rand(N, ci, Su, Su, Su), rand(N, co, S, S, S)
    shape = p2v_tail.UP_KERNEL_SHAPE
    w = torch.zeros(shape, device='cuda')

    def lib_up_dw(x, g, w):
        return torch.ops.aten.convolution_backward(g, x, w, None, [2] * 3, [1] * 3, [1] * 3,
                                                   True, [0] * 3, 1, [False, True, False])[1]

    chk.compare('p2v_up_dw', 'up5 dw', p2v_tail.up_weight_grad(x, g, shape),
                lib_up_dw(x.double(), g.double(), w.double()), 1e-5, True)
    with cudnn_tf32():
        chk.timed('p2v_up_dw', 'up5 dw', lambda: p2v_tail.up_weight_grad(x, g, shape),
                  lambda: lib_up_dw(x, g, w), 3, main=True, library=True)
    chk.add_bound('p2v_up_dw', 4 * (x.numel() + g.numel() + w.numel()),
                  2 * N * Su ** 3 * ci * co * 64, TF32_FLOP_S)
    del x, g
    torch.cuda.empty_cache()


def phantom_batch(spec, device, B=2):
    """(accum, B, ...) batch of phantom labels: accum x B samples at the hires grid,
    their NIfTI affines, identity view affines (as the JAX package's bench)."""
    from acquisition_focus_tpu_torch.data import make_heart_phantom
    accum = spec.num_grad_accum_steps
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
        make_epix2vox_optimizer, make_reconstruction_optimizer, make_transform_optimizer)
    unet, atms = train.make_models(spec, device)
    train.init_params(unet, atms, torch.Generator().manual_seed(seed))
    if spec.model_type in train.EPIX2VOX_TYPES:
        recon = make_epix2vox_optimizer(unet, updates_per_epoch=10)
    else:
        recon = make_reconstruction_optimizer(unet.parameters(), 1e-3, updates_per_epoch=10)
    trans = make_transform_optimizer(atms.parameters(), 1e-3, epochs=80,
                                     updates_per_epoch=10)
    return unet, atms, recon, trans


SAVE_ALL_PEAK = 16_985_350_144  # B: the default step's peak with no recompute region,
                                # every residual kept (PERF.md)

STEP_KERNELS = {
    'fwd': ('plane_resample_fwd', 'plane_resample_bwd', 'volume_resample', 'conv3d_fwd'),
    'full': ('plane_resample_fwd', 'plane_resample_bwd', 'volume_resample', 'conv3d_fwd',
             'conv3d_dx', 'conv3d_wgrad'),
}
# (E)Pix2Vox's 128^3 tail (ops/kernels/p2v_tail.py): every one launches in a
# float32 (E)Pix2Vox training step on one card
TAIL_KERNELS = ('p2v_merge_fwd', 'p2v_merge_dx', 'p2v_merge_dw', 'p2v_merge_norm',
                'p2v_merge_sum', 'p2v_up_dw')


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
    for step in range(STEPS):
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
    # K1: one forward and one backward launch per skip level and microbatch, all
    # views in each
    k1 = STEPS * len(spec.base_features) * spec.num_grad_accum_steps
    if launches['plane_resample_fwd'] != k1 or launches['plane_resample_bwd'] != k1:
        raise AssertionError(f"K1 launched {launches['plane_resample_fwd']} / "
                             f"{launches['plane_resample_bwd']} times in {STEPS} steps, "
                             f"expected {k1} each")
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


RECOMPUTE_MODES = (
    ('default', {}),
    ('atm_remat', dict(atm_remat=True)),
    ('unet_remat', dict(unet_remat=True)),
    ('both', dict(atm_remat=True, unet_remat=True)),
    ("('conv_out',)", dict(decoder_save_names=['conv_out'])),
    ("('conv_out','conv_in')", dict(decoder_save_names=['conv_out', 'conv_in'])),
)
RECOMPUTE_GRAD_TOL = 2e-2   # max |grad - default's| per leaf, over the leaf's max |grad|
                            # (pre-norm conv biases, exactly 0: over the largest leaf's)


def first_microbatch_grads(spec, unet, atms, batch):
    """Every parameter gradient (on the host) after the first microbatch of a step,
    as ``train_step`` forms it (loss / accum), from augmentation seed 0; no update."""
    from acquisition_focus_tpu_torch.engine import train
    micro = {k: v[0] for k, v in batch.items()}
    loss, _ = train.forward(spec, unet, atms, micro, torch.Generator().manual_seed(0))
    (loss / spec.num_grad_accum_steps).backward()
    grads = {}
    for prefix, m in (('unet.', unet), ('atms.', atms)):
        for name, p in m.named_parameters():
            if p.grad is not None:
                grads[prefix + name] = p.grad.float().cpu()
            p.grad = None
    return grads


def grad_deviation(grads, ref):
    """The largest per-leaf max |grad - ref| over the leaf's max |ref| (pre-norm
    conv biases, whose exact gradient is 0: over the largest leaf's), and its leaf."""
    if grads.keys() != ref.keys():
        raise AssertionError(f"gradient leaves differ: {sorted(grads.keys() ^ ref.keys())}")
    top = max(float(g.abs().max()) for g in ref.values())
    worst = (-1.0, '')
    for name, g in grads.items():
        pre_norm_bias = name.endswith('conv.bias') or (
            'locnet.convnet' in name and name.endswith('.bias'))
        scale = top if pre_norm_bias else max(float(ref[name].abs().max()), 1e-30)
        worst = max(worst, (float((g - ref[name]).abs().max()) / scale, name))
    return worst


def run_recompute():
    """The default step at full width ('fwd') under each recompute setting of
    RECOMPUTE_MODES, from the same weights, batch and generator seed: the first
    microbatch's gradients against the default's (and the default's against a
    second run of itself), then 1 warm-up and 3 timed steps: s/step, peak memory,
    launches per step, step 0's loss against the default's. Then one step at
    batch 8 x accum 1 under atm_remat + unet_remat."""
    from acquisition_focus_tpu_torch.engine import train
    from acquisition_focus_tpu_torch.engine.runner import DEFAULTS, spec_from_config
    from acquisition_focus_tpu_torch.ops.kernels import _lib
    results, ref = {}, None
    for name, opts in RECOMPUTE_MODES:
        spec = spec_from_config(dict(DEFAULTS, use_pallas_conv3d='fwd', **opts), 6, 3)
        unet, atms, recon, trans = build_step(spec, 'cuda')
        batch = phantom_batch(spec, 'cuda')
        grads = first_microbatch_grads(spec, unet, atms, batch)
        if ref is None:
            ref = grads
            dev = grad_deviation(first_microbatch_grads(spec, unet, atms, batch), ref)
            log(f"  recompute [default, run twice]: first-microbatch gradient deviation "
                f"{dev[0]:.3e} ({dev[1]})")
        else:
            dev = grad_deviation(grads, ref)
        del grads
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        gen = torch.Generator().manual_seed(0)
        times, losses = [], []
        for step in range(STEPS):
            t0 = time.perf_counter()
            loss = float(train.train_step(spec, unet, atms, recon, trans, batch, gen)['loss'])
            torch.cuda.synchronize()
            if step:
                times.append(time.perf_counter() - t0)
            if not np.isfinite(loss):
                raise AssertionError(f"recompute [{name}] step {step}: loss {loss}")
            losses.append(loss)
        r = {'s_step': sum(times) / len(times), 'peak': torch.cuda.max_memory_allocated(),
             'launches_per_step': {k: v / STEPS for k, v in _lib.LAUNCHES.items() if v},
             'loss0': losses[0], 'grad_dev': dev}
        results[name] = r
        base = results['default']
        rel = abs(r['loss0'] - base['loss0']) / abs(base['loss0'])
        log(f"  recompute [{name}]: {r['s_step']:.4f} s/step (mean of {len(times)}), peak "
            f"{r['peak']} B ({r['peak'] / 2**30:.2f} GiB), launches per step "
            f"{r['launches_per_step']}, step 0 loss {r['loss0']!r} (rel diff to the "
            f"default's {rel:.3e}), first-microbatch gradient deviation {dev[0]:.3e} "
            f"({dev[1]})")
        if not rel <= 1e-6:
            raise AssertionError(f"recompute [{name}]: step 0 loss {r['loss0']} vs the "
                                 f"default's {base['loss0']}")
        if not dev[0] <= RECOMPUTE_GRAD_TOL:
            raise AssertionError(f"recompute [{name}]: gradient of {dev[1]} deviates "
                                 f"{dev[0]:.3e} > {RECOMPUTE_GRAD_TOL} from the default's")
        del unet, atms, recon, trans, batch
        torch.cuda.empty_cache()

    # the policy launches each kernel forward once: the counts of a 'fwd' step with
    # no recompute
    per_step = results['default']['launches_per_step']
    want = {'conv3d_fwd': 4, 'plane_resample_fwd': 12, 'plane_resample_bwd': 12,
            'volume_resample': 2}
    if per_step != want:
        raise AssertionError(f"default policy launches per step {per_step}, expected {want}")
    if not results['both']['peak'] < results['default']['peak'] < SAVE_ALL_PEAK:
        raise AssertionError(f"peak memory: both remats {results['both']['peak']} B, "
                             f"default policy {results['default']['peak']} B, save-all "
                             f"{SAVE_ALL_PEAK} B: expected increasing")

    spec = spec_from_config(dict(DEFAULTS, use_pallas_conv3d='fwd', atm_remat=True,
                                 unet_remat=True, num_grad_accum_steps=1), 6, 3)
    unet, atms, recon, trans = build_step(spec, 'cuda')
    batch = phantom_batch(spec, 'cuda', B=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(0)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        loss = float(train.train_step(spec, unet, atms, recon, trans, batch, gen)['loss'])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not np.isfinite(loss):
            raise AssertionError(f"batch 8 x accum 1 step: loss {loss}")
    results['batch8'] = {'s_step': times[-1], 'peak': torch.cuda.max_memory_allocated()}
    log(f"  recompute [both, batch 8 x accum 1]: {times[-1]:.4f} s/step (second step; "
        f"first {times[0]:.4f} s), peak {results['batch8']['peak']} B "
        f"({results['batch8']['peak'] / 2**30:.2f} GiB), loss {loss!r}")
    del unet, atms, recon, trans, batch
    torch.cuda.empty_cache()
    return results


def host_s(fn, calls=3):
    """Mean host seconds of calls 2..``calls`` of ``fn``, each ending in a sync."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sum(times[1:]) / (calls - 1)


N_CASES = 8                 # 6 training cases (fold 0: 4 train, 2 val) + 2 test; 14
                            # until the from-segmented phases needed the time
BUILD_CASE_TOL = 1e-5       # share of a volume's voxels whose label may differ
                            # between the card's and the CPU's build


def run_build(tmp):
    """The dataset build on the card: ``write_phantom_dataset`` writes N_CASES phantom
    cases at 128^3 and 1.5 mm (the default 128^3 @ 192 mm hires grid, not cut) as
    NIfTI files; the port's ``load_or_build`` builds the training and test sets
    from them on the card with the cache off (hires resample, clinical views,
    centroid fit, prescan, reoriented volumes, input view affines). The 2 test
    cases are built again on the CPU with the card's centroid affines injected, and
    everything downstream of them compared; the centroid fits of the two builds are
    compared apart, without a gate. Returns the data directory and the card's
    (training, test) datasets."""
    from acquisition_focus_tpu_torch.data import base_dataset
    from acquisition_focus_tpu_torch.data.cache import load_or_build
    from acquisition_focus_tpu_torch.data.mmwhs import MMWHSDataset
    from acquisition_focus_tpu_torch.data.synthetic import write_phantom_dataset
    from acquisition_focus_tpu_torch.engine.runner import load_config

    data = tmp / 'data'
    t0 = time.perf_counter()
    write_phantom_dataset(data, n_cases=N_CASES, shape=(128,) * 3, n_test=2)
    log(f"build: {N_CASES} phantom cases written at 128^3, 1.5 mm in "
        f"{time.perf_counter() - t0:.1f} s")
    config = load_config(overrides=dict(use_caching=False))
    built, fits = {}, []
    original = base_dataset.register_centroids
    for state, device in (('train', None), ('test', None), ('test', 'cpu')):
        where = 'cuda' if device is None else device
        if device == 'cpu':
            card = built['test', 'cuda']
            queue = [card.cases[c]['gt_view_affines']['centroids'].astype(np.float32)
                     for c in sorted(card.cases)]

            def inject(fixed, moving, dof=6, seed=0):
                fits.append(original(fixed, moving, dof=dof, seed=seed))
                return queue.pop(0)

            base_dataset.register_centroids = inject
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            ds = load_or_build(MMWHSDataset, data, config, state, device=device)
        finally:
            base_dataset.register_centroids = original
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        built[state, where] = ds
        log(f"  {state} on {where}: {len(ds)} cases in {dt:.2f} s, "
            f"{dt / len(ds):.3f} s per case")

    card, cpu = built['test', 'cuda'], built['test', 'cpu']
    for (cid, a), fit in zip(sorted(card.cases.items()), fits):
        b = cpu.cases[cid]
        for k in ('label', 'prescan_gt'):
            n = int((a[k] != b[k]).sum())
            log(f"  {cid} {k}: {n} of {a[k].size} voxels differ (limit "
                f"{BUILD_CASE_TOL:g} of them)")
            if a[k].shape != b[k].shape or n > BUILD_CASE_TOL * a[k].size:
                raise AssertionError(f"{cid} {k}: card and CPU builds differ at {n} voxels")
        img = float(np.abs(a['image'] - b['image']).max())
        aff = max(float(np.abs(a[k][v] - b[k][v]).max())
                  for k in ('gt_view_affines', 'prescan_view_affines') for v in a[k])
        inp = float(np.abs(a['input_view_affines'] - b['input_view_affines']).max())
        log(f"  {cid}: image max abs diff {img:.3e} (tol 1e-3); view affines "
            f"{aff:.3e}, input view affines {inp:.3e} (tol 1e-3)")
        if not (img <= 1e-3 and aff <= 1e-3 and inp <= 1e-3):
            raise AssertionError(f"{cid}: card and CPU builds disagree")
        fit_diff = float(np.abs(fit - a['gt_view_affines']['centroids']).max())
        log(f"  {cid}: centroid fit, CPU vs card, max abs diff {fit_diff:.3e} (not "
            f"gated: 500 AdamW steps that do not converge amplify the class centers' "
            f"float32 rounding, PARITY.md)")
    return data, (built['train', 'cuda'], card)


def check_sweep(state_path, runs_dir, stages):
    """Read back what a CLI sweep wrote: the sweep state lists ``stages`` in
    order, each stage's ``metrics.jsonl`` has finite losses and its own best
    checkpoint, each opt stage after the first loaded the previous stage's save as
    its transform checkpoint, and its frozen views' ATMs are bit-equal to that
    save while its trained view moved. Returns (completed, keys, epoch seconds)."""
    from acquisition_focus_tpu_torch.engine.checkpoint import load_checkpoint
    completed = json.loads(state_path.read_text())['completed']
    keys = list(completed)
    if [k.split('/')[-1] for k in keys] != stages:
        raise AssertionError(f"sweep state lists the stages {keys}")
    epochs_total = 0.0
    for i, key in enumerate(keys):
        rec = completed[key]
        run_name = rec['run_name']
        recs = [json.loads(line) for line in
                (runs_dir / run_name / 'metrics.jsonl').read_text().splitlines()]

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
    return completed, keys, epochs_total


def run_sweep(tmp, data):
    """The stage sweep through the CLI, at full width: ``main.main`` with a meta
    config (DEFAULTS with epochs 2, 'full', theta_refresh_every 2, the built
    phantom dataset, fold 0, cache off) builds the cases from the NIfTI files on
    the card and runs opt_view0..2 and ref, 2 epochs each (epoch 0 trains the
    locnet, epoch 1 runs from cached thetas and computes the heavy metrics on the
    device), 4 training, 2 validation and 2 test cases at 128^3, with the build's
    p2CH view planes. Per stage it reads what the run writes: the sweep state
    (saves, the transform checkpoint each opt stage loaded) and ``metrics.jsonl``
    (epoch seconds, scores)."""
    from acquisition_focus_tpu_torch import main as cli
    from acquisition_focus_tpu_torch.engine.runner import load_config
    from acquisition_focus_tpu_torch.ops.kernels import _lib

    state_path = tmp / 'sweep_state.json'
    meta = tmp / 'meta.json'
    meta.write_text(json.dumps(dict(
        epochs=2, use_pallas_conv3d='full', theta_refresh_every=2, save_every='best',
        do_output=True, sweep_state_path=str(state_path), log_dir=str(tmp / 'runs'),
        mdl_save_prefix=str(tmp / 'models'), dataset=['synthetic', str(data)],
        fold_override=0, use_caching=False)))
    config = load_config(None, meta)
    log(f"sweep: python -m acquisition_focus_tpu_torch.main --meta_config_path {meta.name}: "
        f"DEFAULTS with epochs 2, use_pallas_conv3d 'full', theta_refresh_every 2, "
        f"save_every 'best', fold 0, cache off; {config['base_views']} views, "
        f"{config['hires_fov_vox']} @ {config['hires_fov_mm']} mm, batch "
        f"{config['batch_size']} x accum {config['num_grad_accum_steps']}, "
        f"{config['compute_dtype']}")
    log(f"  free disk under the run directory: {shutil.disk_usage(tmp).free} B")

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(['--meta_config_path', str(meta), '--base_dir', str(tmp)])
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    log(f"  CLI run (dataset build + sweep) {sweep_s:.1f} s; kernel launches: {launches}")
    missing = [k for k in STEP_KERNELS['full'] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in the sweep: {missing}")

    completed, keys, epochs_total = check_sweep(
        state_path, tmp / 'runs', ['opt_view0', 'opt_view1', 'opt_view2', 'ref'])
    log(f"  epochs {epochs_total:.3f} s of the CLI run's {sweep_s:.3f} s; the rest is "
        f"the dataset build, the stages' model builds, checkpoint loads and saves")
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


EPIX_EPOCHS = 2             # epochs per stage of the (E)Pix2Vox sweep


def run_epix2vox_sweep(tmp, data):
    """The (E)Pix2Vox stage sweep through the CLI: ``main.main`` with a meta config
    like ``meta_configs/meta_configs_MMWHS/config_dict_id21.json`` without its
    stage override (hybrid-EPix2Vox, views p2CH and p4CH, binarized labels), at
    batch 1 x accum 4, 2 epochs per stage, fold 0, cache off, on the phantom files
    of the build phase: opt_view0, opt_view1 and ref. The model computes in
    float32 with PyTorch's default TF32 for cuDNN convolutions. K2 (the prescan
    resample of the opt stages) and the 128^3 tail's kernels (``TAIL_KERNELS``)
    must launch."""
    from acquisition_focus_tpu_torch import main as cli
    from acquisition_focus_tpu_torch.ops.kernels import _lib

    state_path = tmp / 'epix_sweep_state.json'
    meta = tmp / 'epix_meta.json'
    meta.write_text(json.dumps(dict(
        model_type='hybrid-EPix2Vox', base_views=['p2CH', 'p4CH'],
        use_binarized_labels=True, batch_size=1, num_grad_accum_steps=4,
        epochs=EPIX_EPOCHS, save_every='best', do_output=True,
        sweep_state_path=str(state_path), log_dir=str(tmp / 'epix_runs'),
        mdl_save_prefix=str(tmp / 'epix_models'), dataset=['synthetic', str(data)],
        fold_override=0, use_caching=False)))
    log(f"(E)Pix2Vox sweep: python -m acquisition_focus_tpu_torch.main --meta_config_path "
        f"{meta.name}: hybrid-EPix2Vox, p2CH + p4CH, binarized, batch 1 x accum 4, "
        f"{EPIX_EPOCHS} epochs per stage, fold 0, cache off, TF32 on")
    torch.cuda.synchronize()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        cli.main(['--meta_config_path', str(meta), '--base_dir', str(tmp)])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    sweep_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    log(f"  CLI run (dataset build + sweep) {sweep_s:.1f} s; kernel launches: {launches}")
    missing = [k for k in ('volume_resample',) + TAIL_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in the (E)Pix2Vox sweep: {missing}")
    _, _, epochs_total = check_sweep(state_path, tmp / 'epix_runs',
                                     ['opt_view0', 'opt_view1', 'ref'])
    log(f"  epochs {epochs_total:.3f} s of the CLI run's {sweep_s:.3f} s")
    torch.cuda.empty_cache()
    return launches


def epix2vox_batch(spec, device):
    """(accum, 1, ...) batch of binarized phantom labels at the hires grid (seeds
    0..accum-1), their NIfTI affines, identity view affines."""
    from acquisition_focus_tpu_torch.data import make_heart_phantom
    S = tuple(spec.hires_fov_vox)
    spacing = tuple(m / v for m, v in zip(spec.hires_fov_mm, spec.hires_fov_vox))
    accum = spec.num_grad_accum_steps
    samples = [make_heart_phantom(shape=S, seed=i, spacing=spacing) for i in range(accum)]
    label = np.stack([s[0] > 0 for s in samples]).astype(np.int64).reshape((accum, 1) + S)
    nii = np.stack([s[2] for s in samples]).reshape(accum, 1, 4, 4)
    views = np.broadcast_to(np.eye(4), (accum, spec.n_views, 1, 4, 4))
    return {'label': torch.tensor(label, device=device),
            'nii_affine': torch.tensor(nii, dtype=torch.float32, device=device),
            'view_affines': torch.tensor(np.array(views), dtype=torch.float32,
                                         device=device)}


def run_epix2vox_steps():
    """(E)Pix2Vox training steps at the sweep's shape (2 views, binarized, batch 1
    x accum 4, 128^3, the opt-all locnets of DEFAULTS): hybrid-EPix2Vox, 1 warm-up
    and 3 timed steps with cuDNN's TF32 on (PyTorch's default, which the port
    keeps), then 1 + 3 with it off, peak memory over each; then one hybrid-Pix2Vox
    step. Losses and parameters must stay finite."""
    from acquisition_focus_tpu_torch.engine import train
    from acquisition_focus_tpu_torch.engine.runner import DEFAULTS, spec_from_config
    result = {}
    for model_type in ('hybrid-EPix2Vox', 'hybrid-Pix2Vox'):
        spec = spec_from_config(dict(DEFAULTS, model_type=model_type,
                                     base_views=['p2CH', 'p4CH'], use_binarized_labels=True,
                                     batch_size=1, num_grad_accum_steps=4), 2, 2)
        unet, atms, recon, trans = build_step(spec, 'cuda')
        batch = epix2vox_batch(spec, 'cuda')
        gen = torch.Generator().manual_seed(0)
        n_params = sum(p.numel() for p in unet.parameters())
        modes = (True, False) if model_type == 'hybrid-EPix2Vox' else (True,)
        steps = STEPS if model_type == 'hybrid-EPix2Vox' else 1
        for tf32 in modes:
            torch.backends.cudnn.allow_tf32 = tf32
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for step in range(steps):
                t0 = time.perf_counter()
                loss = float(train.train_step(spec, unet, atms, recon, trans, batch,
                                              gen)['loss'])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if not np.isfinite(loss):
                    raise AssertionError(f"{model_type} step {step}: loss {loss}")
            peak = torch.cuda.max_memory_allocated()
            s_step = sum(times[1:]) / len(times[1:]) if steps > 1 else times[0]
            log(f"  [{model_type}, TF32 {'on' if tf32 else 'off'}] {n_params} params; "
                f"s/step {s_step:.4f} ({'mean of 3 after 1 warm-up' if steps > 1 else 'one step, with its warm-up'}); "
                f"losses end {loss!r}; max_memory_allocated {peak} B "
                f"({peak / 2**30:.2f} GiB)")
            result[model_type, tf32] = {'s_step': s_step, 'peak': peak}
        torch.backends.cudnn.allow_tf32 = False
        for p in unet.parameters():
            if not torch.isfinite(p).all():
                raise AssertionError(f"{model_type}: non-finite parameter after the steps")
        del unet, atms, recon, trans, batch
        torch.cuda.empty_cache()
    return result


def check_epix2vox_reference():
    """An EPix2VoxModel128 forward (V 2, B 1, Kaiming weights from seed 0) on the
    GPU in float32 with TF32 off against the same forward on the CPU, on views made
    by the interface adapter from phantom slices: the occupancy within 2e-4 (max
    abs; it lies in [0, 1]; measured 2.3e-5 on an NVIDIA H100 at 700 W). The sums
    of the 78M-parameter model run in another order on the GPU."""
    from acquisition_focus_tpu_torch.data import make_heart_phantom
    from acquisition_focus_tpu_torch.models.epix2vox import (
        EPix2VoxModel128, epix2vox_interface_input, init_weights)
    label = make_heart_phantom((128,) * 3, seed=0)[0] > 0
    planes = np.stack([np.eye(2)[label[64].astype(int)], np.eye(2)[label[:, 64].astype(int)]])
    b_input = torch.tensor(planes.transpose(0, 3, 1, 2).reshape(1, 4, 128, 128),
                           dtype=torch.float32)
    model = EPix2VoxModel128(2, use_epix2vox=True)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = model(epix2vox_interface_input(b_input, 2))
        got = model.cuda()(epix2vox_interface_input(b_input.cuda(), 2)).cpu()
    err = (got - ref).abs().max().item()
    log(f"(E)Pix2Vox forward, GPU (float32, TF32 off) vs CPU: occupancy {tuple(got.shape)} "
        f"in [{ref.min().item():.4f}, {ref.max().item():.4f}], max abs diff {err:.3e} "
        f"(tol 2e-4)  {'ok' if err <= 2e-4 else 'FAIL'}")
    if not err <= 2e-4:
        raise AssertionError(f"(E)Pix2Vox forward: GPU vs CPU max abs diff {err:.3e}")
    del model
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


SEG_STEPS = 300             # segmenter training steps (the recipe's default: 50 x 50)
# config_dict_id13.json's from-segmented settings; segment_extra_permute off for the
# in-framework segmenter
FS_META = dict(base_views=['axial', 'coronal'], prescan_fov_mm=[192.0] * 3,
               prescan_fov_vox=[32] * 3, clinical_view_affine_type='from-segmented',
               label_slice_type='from-segmented', segment_extra_permute=False)
# set explicitly: a segmenter trained for SEG_STEPS steps may miss the default
# build gate (Dice 0.5, HD95 12 mm)
FS_GATE = dict(min_prescan_dice=0.0, max_prescan_hd95_mm=1e9)


def train_segmenter_on_card(tmp, data):
    """``scripts/train_segmenter.py`` on the card at full width: reference features
    (32..512), the 128^2 slices of the 128^3 @ 1.5 mm training volumes of the
    build phase's files, batch 8, GIN and ``--multires``, SEG_STEPS steps from
    seed 0. Returns the checkpoint path and the script's summary."""
    from acquisition_focus_tpu_torch.scripts import train_segmenter
    ckpt = tmp / 'segmenter.pt'
    log(f"segmenter: python -m acquisition_focus_tpu_torch.scripts.train_segmenter "
        f"--dataset synthetic --epochs 1 --steps_per_epoch {SEG_STEPS} --batch 8 "
        f"--multires (128^2 @ 1.5 mm, features 32..512)")
    t0 = time.perf_counter()
    res = train_segmenter.main([
        '--data_dir', str(data), '--out', str(ckpt), '--dataset', 'synthetic',
        '--epochs', '1', '--steps_per_epoch', str(SEG_STEPS), '--batch', '8', '--multires',
        '--seed', '0', '--cache_dir', str(tmp / 'seg_cache')])
    torch.cuda.synchronize()
    log(f"  segmenter: {res['steps']} steps, {res['s_step']:.4f} s/step after the first, "
        f"final loss {res['final_loss']!r}; {time.perf_counter() - t0:.1f} s with its "
        f"dataset build")
    if res['steps'] != SEG_STEPS or not np.isfinite(res['final_loss']):
        raise AssertionError(f"segmenter training: {res}")
    return ckpt, res


def build_from_segmented(tmp, data, ckpt):
    """The from-segmented build of the 2 test cases on the card (``load_or_build``,
    cache off): the 32^3 @ 192 mm prescan image resampled from the hires image and
    segmented by the trained segmenter, its view planes, the centroid base on the
    hires-interpolated segmentation; per case its Dice and HD95 against the GT, and
    seconds per case. The gate's quality, computed on the card, is held against the
    host's on the same segmentation moved to the CPU: Dice equal to 1e-12, HD95
    against scipy's EDT (the JAX package's) within 1e-6 mm."""
    from acquisition_focus_tpu_torch.data import base_dataset
    from acquisition_focus_tpu_torch.data.cache import load_or_build
    from acquisition_focus_tpu_torch.data.mmwhs import MMWHSDataset
    from acquisition_focus_tpu_torch.engine.metrics import hausdorff_per_class
    from acquisition_focus_tpu_torch.engine.runner import load_config
    config = load_config(overrides=dict(FS_META, **FS_GATE, segment_model_path=str(ckpt),
                                        use_caching=False))
    log(f"from-segmented build: prescan {config['prescan_fov_vox']} @ "
        f"{config['prescan_fov_mm']} mm, segment_extra_permute false; build gate set "
        f"explicitly to min_prescan_dice {FS_GATE['min_prescan_dice']}, "
        f"max_prescan_hd95_mm {FS_GATE['max_prescan_hd95_mm']:g}")
    quality, seen = base_dataset._prescan_quality, []

    def recorded(seg, gt, nii, n):
        q = quality(seg, gt, nii, n)
        seen.append((seg.is_cuda, seg.cpu(), gt.cpu(), nii, n, q))
        return q

    base_dataset._prescan_quality = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = load_or_build(MMWHSDataset, data, config, 'test')
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        base_dataset._prescan_quality = quality
    if len(seen) != len(ds) or not all(r[0] for r in seen):
        raise AssertionError(f"prescan quality: {len(seen)} calls for {len(ds)} cases, "
                             f"on the card: {[r[0] for r in seen]}")
    for _, seg, gt, nii, n, q in seen:
        host = quality(seg, gt, nii, n)
        zoom = float(np.linalg.norm(np.sqrt((np.asarray(nii, np.float32)[:3, :3] ** 2).sum(0))))
        scipy_hd95 = hausdorff_per_class(seg[None].numpy(), gt[None].numpy(), n, 95)[0] * zoom
        d_dice = np.nanmax(np.abs(q['dice'] - host['dice']))
        d_hd = max(np.nanmax(np.abs(q['hd95'] - h)) for h in (host['hd95'], scipy_hd95))
        same_nan = all(np.array_equal(np.isnan(q[k]), np.isnan(h)) for k, h in
                       (('dice', host['dice']), ('hd95', host['hd95']), ('hd95', scipy_hd95)))
        ok = d_dice <= 1e-12 and d_hd <= 1e-6 and same_nan
        log(f"  prescan quality, card vs host (same segmentation): Dice max diff {d_dice:.3e} "
            f"(tol 1e-12), HD95 vs the CPU and scipy max diff {d_hd:.3e} mm (tol 1e-6), "
            f"NaNs alike {same_nan}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"prescan quality card vs host: {q} vs {host}, scipy "
                                 f"{scipy_hd95}")
    for cid, case in sorted(ds.cases.items()):
        q = case['prescan_quality']
        gap = np.abs(case['prescan_view_affines']['axial']
                     - case['gt_view_affines']['axial']).max()
        log(f"  {cid}: prescan Dice {q['dice_mean']!r}, HD95 {q['hd95_mean']!r} mm; "
            f"per class Dice {np.round(q['dice'][1:], 4).tolist()}; axial view affine "
            f"vs GT's max abs diff {gap:.4f}")
        if case['prescan_label'].shape != (32,) * 3:
            raise AssertionError(f"{cid}: prescan label {case['prescan_label'].shape}")
    log(f"  {len(ds)} cases in {dt:.2f} s, {dt / len(ds):.3f} s per case")
    return {'s_per_case': dt / len(ds),
            'quality': {c: ds.cases[c]['prescan_quality']['dice_mean'] for c in ds.cases}}


def run_from_segmented_sweep(tmp, data, ckpt):
    """The from-segmented sweep through the CLI at full width: a meta config like
    ``config_dict_id13.json`` (axial + coronal, 32^3 @ 192 mm prescan, from-segmented
    view planes and label slices) with the trained segmenter, ``'full'``, 2 epochs
    per stage (80 in the config), fold 0, cache off: opt_view0, opt_view1 and ref;
    validation and test segment the image slices. K1f, K1b, K2, K3 (forward and
    input gradient) and K4 must all launch in it."""
    from acquisition_focus_tpu_torch import main as cli
    from acquisition_focus_tpu_torch.ops.kernels import _lib
    state_path = tmp / 'fs_sweep_state.json'
    meta = tmp / 'fs_meta.json'
    meta.write_text(json.dumps(dict(
        FS_META, **FS_GATE, segment_model_path=str(ckpt), epochs=2,
        use_pallas_conv3d='full', save_every='best', do_output=True,
        sweep_state_path=str(state_path), log_dir=str(tmp / 'fs_runs'),
        mdl_save_prefix=str(tmp / 'fs_models'), dataset=['synthetic', str(data)],
        fold_override=0, use_caching=False)))
    log(f"from-segmented sweep: python -m acquisition_focus_tpu_torch.main "
        f"--meta_config_path {meta.name}: config_dict_id13.json's views and prescan, "
        f"from-segmented, 'full', 2 epochs per stage, fold 0, cache off, build gate as "
        f"above")
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(['--meta_config_path', str(meta), '--base_dir', str(tmp)])
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    log(f"  CLI run (dataset build + sweep) {sweep_s:.1f} s; kernel launches: {launches}")
    missing = [k for k in STEP_KERNELS['full'] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in the from-segmented sweep: {missing}")
    _, _, epochs_total = check_sweep(state_path, tmp / 'fs_runs',
                                     ['opt_view0', 'opt_view1', 'ref'])
    log(f"  epochs {epochs_total:.3f} s of the CLI run's {sweep_s:.3f} s")
    torch.cuda.empty_cache()
    return launches, sweep_s


def check_from_segmented_reference(ckpt):
    """A float32 from-segmented ``eval_step`` at 32^2 slices of 6 mm (the shape of
    ``config_dict_id14.json``: respaced to 128^2 for the segmenter, the one-hot
    prediction shrunk to the 32^2 hires plane) with the trained segmenter, on the
    GPU (TF32 off) against the CPU, narrow reconstruction widths. The segmented
    slices may differ at argmax near-ties: at most 1e-3 of their pixels; the loss
    within 1e-3 of its value. Then ``slice_min_principal_align_affines`` of phantom
    label slices on the GPU against the CPU, on what is invariant to an
    eigenvector's sign: the in-plane axis up to its sign, and the aligned slice up
    to the 180-degree turn. Also reports on how many of these inertia tensors
    cuSOLVER's ``torch.linalg.eigh`` picks the other sign than LAPACK's ``syevd``
    (the port solves them on the host, as the JAX package's CPU ``eigh``)."""
    from acquisition_focus_tpu_torch.data import make_heart_phantom
    from acquisition_focus_tpu_torch.engine import train
    from acquisition_focus_tpu_torch.engine.segmenter import load_segmenter
    from acquisition_focus_tpu_torch.geometry.moments import (
        label_inertia_tensor, principal_axes, slice_min_principal_align_affines)
    from acquisition_focus_tpu_torch.ops.resample import nifti_grid_sample
    spec = train.StageSpec(
        n_views=2, num_classes=6, n_active_views=2, view_optimization_mode='opt-all',
        use_affine_theta=True, hires_fov_mm=(192.0,) * 3, hires_fov_vox=(32,) * 3,
        slice_fov_mm=(192.0, 192.0, 6.0), slice_fov_vox=(32, 32, 1),
        prescan_fov_mm=(192.0,) * 3, prescan_fov_vox=(32,) * 3, compute_dtype='float32',
        augment_input=False, base_features=(4, 8, 16), locnet_width=2,
        label_slice_type='from-segmented')
    phantoms = [make_heart_phantom((32,) * 3, seed=20 + i, spacing=(6.0,) * 3)
                for i in range(2)]
    batch = {'label': np.stack([p[0] for p in phantoms]),
             'image': np.stack([p[1] for p in phantoms]),
             'nii_affine': np.broadcast_to(np.diag([6.0, 6.0, 6.0, 1.0]), (2, 4, 4)),
             'view_affines': rotations(np.random.default_rng(2), 4, 0.05).cpu().numpy()
             .reshape(2, 2, 4, 4)}
    out = {}
    for device in ('cpu', 'cuda'):
        unet, atms, _, _ = build_step(spec, device)
        b = {k: torch.tensor(np.array(v), device=device,
                             dtype=torch.int64 if k == 'label' else torch.float32)
             for k, v in batch.items()}
        seg = load_segmenter(ckpt, 6, device)
        out[device] = train.eval_step(spec, unet, atms, b, segmenter=seg)
    c, g = out['cpu'], out['cuda']
    lab_c = c['b_input'].reshape(2, 2, 6, 32, 32).argmax(2)
    lab_g = g['b_input'].cpu().reshape(2, 2, 6, 32, 32).argmax(2)
    flipped = (lab_c != lab_g).float().mean().item()
    rel = abs(g['loss'].item() - c['loss'].item()) / max(abs(c['loss'].item()), 1e-30)
    log(f"from-segmented eval_step at 32^2 slices (6 mm), GPU vs CPU: segmented slice "
        f"labels differ at {flipped:.3e} of the pixels (tol 1e-3); loss {g['loss'].item()!r}"
        f" vs {c['loss'].item()!r}, rel diff {rel:.3e} (tol 1e-3)")
    if not (flipped <= 1e-3 and rel <= 1e-3):
        raise AssertionError(f"from-segmented eval_step: GPU vs CPU {flipped}, {rel}")

    lbl = make_heart_phantom((32,) * 3, seed=1)[0]
    sl = np.stack([lbl[i] for i in range(6, 26, 2)] + [lbl[:, i] for i in range(6, 26, 3)])
    sl = torch.tensor(sl[..., None].astype(np.int32))
    align = {d: slice_min_principal_align_affines(sl.to(d)).cpu() for d in ('cpu', 'cuda')}
    axis_c, axis_g = align['cpu'][:, :3, 1], align['cuda'][:, :3, 1]
    axis_err = (torch.abs((axis_c * axis_g).sum(-1)) - 1).abs().max().item()
    onehot = torch.nn.functional.one_hot(sl.long(), 6)[..., 0, :].permute(0, 3, 1, 2)[..., None]
    nii = torch.eye(4).repeat(len(sl), 1, 1)
    content = {d: nifti_grid_sample(onehot.float(), nii, pre_grid_sample_affine=align[d])[0]
               .argmax(1) for d in align}
    same = (content['cpu'] == content['cuda']).float().flatten(1).mean(1)
    turned = (content['cpu'] == content['cuda'].flip(1, 2)).float().flatten(1).mean(1)
    worst = 1.0 - torch.maximum(same, turned).min().item()
    n_turned = int((turned > same).sum())
    sign_flips = 0
    for s in sl:
        _, inertia = label_inertia_tensor(s.cuda() != 0)
        v_cusolver = torch.linalg.eigh(inertia)[1][:, 0].cpu().numpy()
        sign_flips += int(np.dot(v_cusolver, principal_axes(inertia)[0]) < 0)
    log(f"slice alignment, GPU vs CPU, {len(sl)} phantom slices: in-plane axis "
        f"| |dot| - 1 | max {axis_err:.3e} (tol 1e-5); aligned content differs at "
        f"{worst:.3e} of the pixels at most (tol 1e-3), {n_turned} slices turned by 180 "
        f"degrees; cuSOLVER eigh picks the other sign than LAPACK's syevd on "
        f"{sign_flips} of {len(sl)} inertia tensors (the port solves on the host)")
    if not (axis_err <= 1e-5 and worst <= 1e-3):
        raise AssertionError(f"slice alignment GPU vs CPU: {axis_err}, {worst}")
    return {'eval_flipped': flipped, 'eval_loss_rel': rel, 'align_axis_err': axis_err,
            'align_content_err': worst, 'cusolver_sign_flips': sign_flips,
            'n_slices': len(sl)}


def run_from_segmented(tmp, data):
    """The from-segmented phases in order: the segmenter's training, the build, the
    CLI sweep, the GPU-vs-CPU checks."""
    ckpt, seg = train_segmenter_on_card(tmp, data)
    build = build_from_segmented(tmp, data, ckpt)
    launches, sweep_s = run_from_segmented_sweep(tmp, data, ckpt)
    ref = check_from_segmented_reference(ckpt)
    return {'segmenter': seg, 'build': build, 'launches': launches, 'sweep_s': sweep_s,
            'reference': ref}


def world_of_one(tmp, name, config, fold, train, test, library_tail=False):
    """``run_dl`` of ``config`` (one epoch, saved) without a mesh, then in an NCCL
    process group of one rank on {'data': 1} (the gradient all-reduce over
    'data', and for (E)Pix2Vox the batch norms given their group) and on
    {'model': 1} (every module the rule splits its sharded stand-in, every
    collective at world size 1): the losses and scores in ``metrics.jsonl`` and
    the epoch's checkpoint bit-equal to the unmeshed run's. ``library_tail``
    ((E)Pix2Vox): the stand-ins keep the library's path where the whole model
    runs the 128^3 tail's kernels, so {'model': 1} is held against a second
    unmeshed run with the tail on the library's path. The kernel counts are set
    to 0 just before the mesh runs and read just after. Returns them."""
    from unittest import mock

    import torch.distributed as dist
    from acquisition_focus_tpu_torch.engine.checkpoint import load_checkpoint
    from acquisition_focus_tpu_torch.engine.runner import run_dl
    from acquisition_focus_tpu_torch.models import epix2vox
    from acquisition_focus_tpu_torch.ops.kernels import _lib
    from acquisition_focus_tpu_torch.parallel.mesh import free_port
    runs = {'no mesh': None, "{'data': 1}": {'data': 1}, "{'model': 1}": {'model': 1}}
    if library_tail:
        runs = {'no mesh': None, 'no mesh, tail on the library': None, **runs}
    reference = {"{'model': 1}": 'no mesh, tail on the library'} if library_tail else {}
    seconds = {}
    for i, (label, shape) in enumerate(runs.items()):
        if shape is not None and not dist.is_initialized():
            dist.init_process_group('nccl', init_method=f'tcp://localhost:{free_port()}',
                                    rank=0, world_size=1)
            torch.cuda.synchronize()
            _lib.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(epix2vox, '_tail_on_card', lambda *args: False) \
                if label == 'no mesh, tail on the library' else contextlib.nullcontext():
            run_dl(str(tmp), dict(config, mesh_shape=shape), fold, training_dataset=train,
                   test_dataset=test, run_name=f'{name}{i}')
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    dist.destroy_process_group()
    log(f"  run_dl seconds {seconds}; kernel launches in the mesh runs: {launches}")

    def logged(i):
        recs = [json.loads(line) for line in
                (tmp / 'mesh_runs' / f'{name}{i}' / 'metrics.jsonl').read_text().splitlines()]
        return [(r['step'], k, v) for r in recs for k, v in sorted(r.items())
                if k.startswith(('losses/', 'scores/'))]

    def tensors(tree, prefix=''):
        if isinstance(tree, torch.Tensor):
            return {prefix: tree}
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in tensors(v, f'{prefix}/{k}').items()}
        return {}

    index = {label: i for i, label in enumerate(runs)}
    for i, label in enumerate(runs):
        if runs[label] is None:
            continue
        ref = index[reference.get(label, 'no mesh')]
        ref_log = logged(ref)
        ref_ck = tensors(load_checkpoint(tmp / 'mesh_models' / f'{name}{ref}_epx0'))
        got = tensors(load_checkpoint(tmp / 'mesh_models' / f'{name}{i}_epx0'))
        differ = [k for k in ref_ck if k not in got or not torch.equal(ref_ck[k], got[k])]
        got_log = logged(i)
        same_log = got_log == ref_log
        log(f"  {label}: {len(ref_log)} logged losses and scores bit-equal to the "
            f"run '{list(runs)[ref]}': {same_log}; checkpoint tensors {len(ref_ck)}, "
            f"differing {len(differ)} {differ[:3]}")
        if not same_log:
            log(f"    first logged values that differ: "
                f"{[(a, b) for a, b in zip(ref_log, got_log) if a != b][:4]}")
        if not same_log or differ or got.keys() != ref_ck.keys():
            raise AssertionError(f"{name}: mesh {label} on one card is not the unmeshed run")
    for i in range(len(runs)):
        (tmp / 'mesh_models' / f'{name}{i}_epx0').unlink()
    return launches


def binarized(dataset, config):
    """``dataset``'s cases with their labels binarized, as a build under
    ``use_binarized_labels`` makes them (foreground = every class but 0)."""
    return type(dataset).from_cases(
        {cid: dict(case, label=(case['label'] > 0).astype(case['label'].dtype))
         for cid, case in dataset.cases.items()}, config, dataset.state)


def run_mesh(tmp, datasets):
    """The device mesh on this card, for the hybrid U-Net and for (E)Pix2Vox
    (``world_of_one``, each path's counts set to 0 just before its mesh runs and
    read just after): ``run_dl`` at full width (one epoch, fold 0 of the build's
    cases: 4 train, 2 val, 2 test) under ``'full'``, every kernel launching; then
    the model keys of ``config_dict_id21.json`` (hybrid-EPix2Vox, p2CH + p4CH,
    binarized labels; DEFAULTS' opt-all localization nets, so K2 launches, and the
    port's default TF32 for cuDNN), with cuDNN's deterministic algorithms, as CUDA
    may otherwise sum in another order from one run to the next. With two or
    more cards, ``smoke_mesh``'s gradient checks on the meshes that fit. Returns
    {path: the mesh runs' launches}."""
    from acquisition_focus_tpu_torch.engine.runner import load_config
    from acquisition_focus_tpu_torch.main import build_fold_iter
    from acquisition_focus_tpu_torch.parallel.mesh import mesh_processes
    train, test = datasets
    common = dict(epochs=1, save_every=1, do_output=False, use_caching=False,
                  log_dir=str(tmp / 'mesh_runs'), mdl_save_prefix=str(tmp / 'mesh_models'))
    config = load_config(overrides=dict(common, use_pallas_conv3d='full'))
    fold = build_fold_iter(dict(config, fold_override=0), train)[0]
    log(f"mesh: run_dl, 1 epoch, 'full', fold 0 ({len(fold[1][0])} train, "
        f"{len(fold[1][1])} val, {len(test)} test cases), without a mesh, then in an "
        f"NCCL process group of one rank on {{'data': 1}} and {{'model': 1}}")
    launches = {'mesh_world_of_one': world_of_one(tmp, 'mesh', config, fold, train, test)}
    missing = [k for k in STEP_KERNELS['full'] if launches['mesh_world_of_one'][k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in the mesh runs: {missing}")

    epix = load_config(overrides=dict(common, model_type='hybrid-EPix2Vox',
                                      base_views=['p2CH', 'p4CH'],
                                      use_binarized_labels=True))
    log("mesh, (E)Pix2Vox: run_dl as above with config_dict_id21.json's model keys "
        "(hybrid-EPix2Vox, p2CH + p4CH, binarized), batch 2 x accum 2, opt-all "
        "locnets, TF32 on, cuDNN deterministic")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, True
    try:
        launches['epix2vox_mesh_world_of_one'] = world_of_one(
            tmp, 'epix_mesh', epix, fold, binarized(train, epix), binarized(test, epix),
            library_tail=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags
    missing = [k for k in ('volume_resample',) + TAIL_KERNELS
               if launches['epix2vox_mesh_world_of_one'][k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in the (E)Pix2Vox mesh runs: {missing}")

    cards = torch.cuda.device_count()
    if cards < 2:
        log("  mesh phase: one card, so the world of one only (the multi-card checks "
            "are smoke_mesh's)")
        return launches
    from acquisition_focus_tpu_torch.scripts import smoke_mesh
    fits = [m for m in smoke_mesh.MESHES if mesh_processes(m) <= cards]
    log(f"  mesh phase: {cards} cards, so also smoke_mesh's gradient checks on {fits}")
    failures = smoke_mesh.check_meshes('cuda', fits, tmp / 'smoke_mesh')[3]
    if failures:
        raise AssertionError(f"smoke_mesh's checks failed: {failures}")
    return launches


ORBAX_DATA = Path(__file__).resolve().parent / 'tests' / 'torch_data'


def orbax_fixture_step(data_dir, device):
    """One float32 ``train_step`` of the port from ``orbax_run.pt``, the port's
    file that ``scripts/import_orbax.py`` wrote from a JAX ``run_dl`` pause of a
    tiny spec (``tests/test_torch_orbax_import.py::write_orbax_fixture``): the
    models and both optimizers restored as ``run_dl`` restores them, on the
    committed batch. Returns the step's loss and the JAX package's on it."""
    from acquisition_focus_tpu_torch.engine import checkpoint, train
    from acquisition_focus_tpu_torch.engine.optimizers import (
        make_reconstruction_optimizer, make_transform_optimizer)
    from acquisition_focus_tpu_torch.engine.runner import load_config, spec_from_config
    data_dir = Path(data_dir)
    meta = json.loads((data_dir / 'orbax_run.json').read_text())
    config = load_config(overrides=meta['config'])
    spec = spec_from_config(config, meta['num_classes'], len(config['base_views']))
    unet, atms = train.make_models(spec, device)
    ck = checkpoint.load_checkpoint(data_dir / 'orbax_run.pt')
    unet.load_state_dict(ck['unet'])
    atms.load_state_dict(ck['atms'])
    recon = make_reconstruction_optimizer(unet.parameters(), config['lr'], 2)
    trans = make_transform_optimizer(atms.parameters(), config['lr'], config['epochs'], 2)
    checkpoint.load_optimizer(*recon, unet, ck['recon_opt'], ck['recon_sched'])
    checkpoint.load_optimizer(*trans, atms, ck['trans_opt'], ck['trans_sched'])
    with np.load(data_dir / 'orbax_batch.npz') as b:
        batch = {k: torch.as_tensor(b[k], device=device) for k in b.files}
    loss = float(train.train_step(spec, unet, atms, recon, trans, batch)['loss'])
    return loss, meta['jax_loss']


def check_orbax_import():
    """Whether ``tensorstore`` (which reads the JAX package's orbax directories)
    imports here; then one float32 step on the card from the committed import of
    a JAX ``run_dl`` pause (``orbax_fixture_step``, TF32 off): its loss within
    1e-4 (rel.) of the JAX package's on the same state and batch."""
    try:
        import tensorstore  # noqa: F401
        have = f"yes ({tensorstore.__version__})"
    except ImportError as e:
        have = f"no ({e})"
    log(f"orbax import: tensorstore imports on this machine: {have}")
    loss, ref = orbax_fixture_step(ORBAX_DATA, 'cuda')
    rel = abs(loss - ref) / abs(ref)
    log(f"  one float32 train_step from tests/torch_data/orbax_run.pt (imported from a "
        f"JAX run_dl pause): loss {loss!r}, JAX {ref!r}, rel diff {rel:.3e} (tol 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError(f"the imported JAX state's step loss {loss} vs JAX {ref}")
    return {'tensorstore': have, 'loss': loss, 'jax_loss': ref, 'rel_diff': rel}


def log_clocks(when):
    """The card's SM clock (and its maximum), temperature and power draw: a card
    running below its clock moves every compute-bound time of the run."""
    log(f"clocks {when}: " + subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw',
         '--format=csv,noheader'], capture_output=True, text=True, check=True).stdout.strip())


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

    log_clocks('at the start')
    rng = np.random.default_rng(0)
    chk = Checker()
    check_volume_resample(chk, rng)
    check_volume_resample_prescan32(chk, np.random.default_rng(3))
    check_plane_resample(chk, rng)
    check_plane_resample_unrounded(chk, rng)
    check_conv3d(chk, rng)
    check_conv3d_grads(chk)
    check_from_segmented_kernels(chk, np.random.default_rng(4))
    from acquisition_focus_tpu_torch.scripts.smoke_mesh import CONVS_MESH
    check_conv3d(chk, np.random.default_rng(5), CONVS_MESH, MESH)
    check_conv3d_grads(chk, CONVS_MESH, MESH)
    torch.cuda.empty_cache()
    check_p2v_tail(chk)
    log_clocks('after the kernel checks')

    fwd = run_steps('fwd')
    full = run_steps('full')
    compare_modes(fwd, full)
    remat = run_recompute()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        data, datasets = run_build(Path(tmp))
        mesh_launches = run_mesh(Path(tmp), datasets)
        del datasets
        launches = run_sweep(Path(tmp), data)
        epix_launches = run_epix2vox_sweep(Path(tmp), data)
        fs = run_from_segmented(Path(tmp), data)
    epix = run_epix2vox_steps()
    check_epix2vox_reference()
    check_small_reference()
    check_orbax_import()

    sources = {
        'plane_resample_fwd': ('acquisition_focus_tpu_torch/csrc/plane_resample.cu',
                               'acquisition_focus_tpu/ops/pallas/plane_resample.py:363'),
        'plane_resample_bwd': ('acquisition_focus_tpu_torch/csrc/plane_resample.cu',
                               'acquisition_focus_tpu/ops/pallas/plane_resample.py:413'),
        'volume_resample': ('acquisition_focus_tpu_torch/csrc/volume_resample.cu',
                            'acquisition_focus_tpu/ops/pallas/volume_resample.py:299'),
        'conv3d_fwd': ('acquisition_focus_tpu_torch/csrc/conv3d.cu',
                       'acquisition_focus_tpu/ops/pallas/conv3d.py:143'),
        # K3 launched as the conv's input gradient ('dx'/'full' modes)
        'conv3d_dx': ('acquisition_focus_tpu_torch/csrc/conv3d.cu',
                      'acquisition_focus_tpu/ops/pallas/conv3d.py:143'),
        'conv3d_wgrad': ('acquisition_focus_tpu_torch/csrc/conv3d_wgrad.cu',
                         'acquisition_focus_tpu/ops/pallas/conv3d.py:248'),
        # (E)Pix2Vox's 128^3 tail: the JAX package leaves these layers to XLA
        **{name: ('acquisition_focus_tpu_torch/csrc/p2v_tail.cu', None)
           for name in TAIL_KERNELS},
    }
    kernels = [{'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
                'launches': launches[name],
                'launches_by_path': {'sweep': launches[name],
                                     'epix2vox_sweep': epix_launches[name],
                                     'from_segmented_sweep': fs['launches'][name],
                                     **{path: counts[name]
                                        for path, counts in mesh_launches.items()}},
                'launches_per_step': {
                    **{m: r['launches'][name] / STEPS for m, r in (('fwd', fwd),
                                                                    ('full', full))},
                    'fwd_unet_remat': remat['unet_remat']['launches_per_step'].get(name, 0)},
                'max_abs_err': chk.rows[name]['max_abs_err'],
                'ms': chk.rows[name]['ms'], 'plain_ms': chk.rows[name]['plain_ms'],
                'bound_ms': chk.rows[name]['bound_ms'],
                'bound_by': chk.rows[name]['bound_by'],
                'library_ms': chk.rows[name].get('library_ms'),
                **({'dense_bound_ms': chk.rows[name]['dense_bound_ms']}
                   if 'dense_bound_ms' in chk.rows[name] else {}),
                **({f'one_view_{k}': chk.rows[ONE_VIEW[name]][k]
                    for k in ('ms', 'plain_ms', 'bound_ms')} if name in ONE_VIEW else {}),
                **({'prescan32': {k: chk.rows[PRESCAN32][k] for k in
                                  ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by')}}
                   if name == 'volume_resample' else {}),
                **({'from_segmented': {k: chk.rows[name + FS].get(k) for k in
                                       ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                                        'bound_by', 'library_ms')}}
                   if name in FS_KERNELS else {}),
                **({'mesh_shards': {k: chk.rows[name + MESH].get(k) for k in
                                    ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                                     'bound_by', 'library_ms')}}
                   if name in MESH_KERNELS else {})}
               for name, (src, rep) in sources.items()]
    for k in kernels:
        for shape in ('prescan32', 'from_segmented', 'mesh_shards'):
            if shape in k:
                k['max_abs_err'] = max(k['max_abs_err'], k[shape]['max_abs_err'])
    log("(E)Pix2Vox s/step at batch 1 x accum 4, 2 views, 128^3: " + "; ".join(
        f"{mt} TF32 {'on' if tf32 else 'off'} {r['s_step']:.4f} s, peak {r['peak']} B"
        for (mt, tf32), r in epix.items()))
    log("recompute ('fwd', batch 2 x accum 2): " + "; ".join(
        f"{m} {remat[m]['s_step']:.4f} s/step, peak {remat[m]['peak']} B"
        for m, _ in RECOMPUTE_MODES) + f"; both at batch 8 x accum 1 "
        f"{remat['batch8']['s_step']:.4f} s/step, peak {remat['batch8']['peak']} B")
    log(f"from-segmented: segmenter {fs['segmenter']['s_step']:.4f} s/step, final loss "
        f"{fs['segmenter']['final_loss']:.4f}; build {fs['build']['s_per_case']:.3f} s per "
        f"case; CLI sweep {fs['sweep_s']:.1f} s; cuSOLVER sign flips "
        f"{fs['reference']['cusolver_sign_flips']} of {fs['reference']['n_slices']}")
    log_clocks('at the end')
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
