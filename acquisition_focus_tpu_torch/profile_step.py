"""Where the default training step's device time goes, by kernel group, on the card.

    python -m acquisition_focus_tpu_torch.profile_step [--modes fwd full] [--rounds 2]
    PYTHONPATH=DIR python -P acquisition_focus_tpu_torch/profile_step.py

For each round and each ``use_pallas_conv3d`` mode in turn: the default
configuration's step (``spec_from_config(DEFAULTS, 6, 3)``, batch 2 x accum 2,
128^3, bf16) from seed-0 weights on phantom labels, 2 warm-up and 3 timed steps
back to back (host clock, ending in a sync), then one step under
``torch.profiler``. It prints the device milliseconds of that step by kernel
group (the copy kernels of ``torch.cat``, ``copy_``, ``.contiguous()`` and dtype
casts in a group of their own), the device total, the wall time of the profiled
step and the device's idle share (1 - device total / wall), the port's kernels one
by one (device ms and launches per step), K1f's device ms per launch by skip level,
step 0's loss and the peak device memory over the unprofiled steps, with the card's
name and power limit. The second form runs this script on the package of checkout
DIR (an earlier commit unpacked with ``git archive``), so two commits are measured
with the same groups. Needs a CUDA device; there is no CPU fallback.
"""

import argparse
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

# kernel-name substrings -> group, first match wins: the port's kernels first
GROUPS = (
    ('K4 conv3d_wgrad (TMA + wgmma, + reduce)', ('wgrad_tma_kernel', 'wgrad_reduce')),
    ('K3 conv3d (TMA + wgmma; forward and as dx)', ('conv3d_tma_kernel',)),
    ('K3/K4 channels-last staging', ('channels_last_kernel',)),
    ('K1f plane_fwd', ('plane_fwd',)),
    ('K1b plane_bwd (cells, + sum)', ('plane_bwd',)),
    ('K2 volume_resample (staging, + bricks)', ('volume_resample',)),
    ('copies (cat, copy_, contiguous, casts)', ('CatArrayBatchedCopy', 'direct_copy_kernel')),
    ('cuDNN layout copies', ('nchwToNhwc', 'nhwcToNchw')),
    ('cuDNN wgrad', ('wgrad',)),
    ('cuDNN dgrad', ('dgrad',)),
    ('instance norm (cuDNN batch-norm kernels)', ('bn_', 'batch_norm', 'batchnorm')),
    ('cuDNN conv fprop', ('fprop', 'conv', 'implicit')),
    ('cuBLAS GEMM', ('gemm', 'Gemm')),
)
OTHER = 'elementwise and other'
PORT_GROUPS = {g for g, _ in GROUPS[:6]}
KERNEL_NAME = re.compile(r'\w*(?:plane_|volume_resample|conv3d|wgrad|channels_last)\w*')


def group_of(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return OTHER


def default_step(mode):
    from acquisition_focus_tpu_torch.data import make_heart_phantom
    from acquisition_focus_tpu_torch.engine import train
    from acquisition_focus_tpu_torch.engine.config import DEFAULTS
    from acquisition_focus_tpu_torch.engine.optimizers import (
        make_reconstruction_optimizer, make_transform_optimizer)
    from acquisition_focus_tpu_torch.engine.runner import spec_from_config
    spec = spec_from_config(dict(DEFAULTS, use_pallas_conv3d=mode), 6, 3)
    unet, atms = train.make_models(spec, 'cuda')
    train.init_params(unet, atms, torch.Generator().manual_seed(0))
    recon = make_reconstruction_optimizer(unet.parameters(), 1e-3, updates_per_epoch=10)
    trans = make_transform_optimizer(atms.parameters(), 1e-3, epochs=80, updates_per_epoch=10)
    accum, B, S = spec.num_grad_accum_steps, 2, tuple(spec.hires_fov_vox)
    spacing = tuple(m / v for m, v in zip(spec.hires_fov_mm, spec.hires_fov_vox))
    samples = [make_heart_phantom(shape=S, seed=i, spacing=spacing) for i in range(accum * B)]
    batch = {
        'label': torch.tensor(np.stack([s[0] for s in samples]).reshape((accum, B) + S),
                              device='cuda'),
        'nii_affine': torch.tensor(np.stack([s[2] for s in samples]).reshape(accum, B, 4, 4),
                                   dtype=torch.float32, device='cuda'),
        'view_affines': torch.eye(4, device='cuda').expand(accum, spec.n_views, B, 4, 4)}
    gen = torch.Generator().manual_seed(0)
    return lambda: float(train.train_step(spec, unet, atms, recon, trans, batch, gen)['loss'])


def profile(mode):
    from torch.profiler import ProfilerActivity, profile as tprofile
    from acquisition_focus_tpu_torch.ops.kernels import plane_resample as k1
    step = default_step(mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss0 = step()
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    back_to_back = (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated()
    # the skip level (out_spat) of each K1f launch, in launch order: the stream runs
    # the kernels in that order, so the i-th K1f kernel of the trace is the i-th call
    levels, fwd = [], k1.plane_resample_fwd

    def record(slices, coefs, out_spat, *args, **kw):
        levels.append(out_spat)
        return fwd(slices, coefs, out_spat, *args, **kw)

    k1.plane_resample_fwd = record
    try:
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        k1.plane_resample_fwd = fwd
    ms, kernels, k1f = {}, {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g, t = group_of(e.name), e.time_range.elapsed_us() / 1e3
            ms[g] = ms.get(g, 0.0) + t
            if g in PORT_GROUPS:
                name = KERNEL_NAME.search(e.name).group(0)
                k_ms, n = kernels.get(name, (0.0, 0))
                kernels[name] = (k_ms + t, n + 1)
            if 'plane_fwd' in e.name:
                k1f.append((e.time_range.start, t))
    by_level = {}
    if len(k1f) == len(levels):
        for S, (_, t) in zip(levels, sorted(k1f)):
            by_level.setdefault(S, []).append(t)
    else:
        print(f"[{mode}] {len(k1f)} K1f kernels in the trace for {len(levels)} calls: "
              "no per-level times", flush=True)
    torch.cuda.empty_cache()
    return ms, wall * 1e3, back_to_back * 1e3, kernels, by_level, loss0, peak


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--modes', nargs='+', default=['fwd', 'full'])
    ap.add_argument('--rounds', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    import acquisition_focus_tpu_torch
    print(smi, f"torch {torch.__version__}", flush=True)
    print(f"package: {Path(acquisition_focus_tpu_torch.__file__).parent}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {m: [] for m in args.modes}
    for _ in range(args.rounds):
        for mode in args.modes:
            results[mode].append(profile(mode))
    groups = [g for g, _ in GROUPS] + [OTHER]
    print(f"device ms per step by kernel group ({', '.join(args.modes)}; "
          f"{args.rounds} profiled steps each, in turns)")
    for g in groups:
        cells = ['/'.join(f"{r[0].get(g, 0.0):.2f}" for r in results[m]) for m in args.modes]
        print(f"  {g:45s} " + '  |  '.join(cells))
    for label, f in (('device total', lambda r: sum(r[0].values())),
                     ('wall under the profiler', lambda r: r[1]),
                     ('device idle share %', lambda r: 100 * (1 - sum(r[0].values()) / r[1])),
                     ('3 steps back to back, mean ms', lambda r: r[2])):
        cells = ['/'.join(f"{f(r):.2f}" for r in results[m]) for m in args.modes]
        print(f"  {label:45s} " + '  |  '.join(cells))
    print("the port's kernels: device ms (launches) per step")
    names = sorted({k for m in args.modes for r in results[m] for k in r[3]})
    for k in names:
        cells = ['/'.join(f"{r[3].get(k, (0.0, 0))[0]:.4f} ({r[3].get(k, (0.0, 0))[1]})"
                          for r in results[m]) for m in args.modes]
        print(f"  {k:45s} " + '  |  '.join(cells))
    print("K1f: device ms per launch (launches per step) by skip level")
    for S in sorted({S for m in args.modes for r in results[m] for S in r[4]}, reverse=True):
        cells = ['/'.join(f"{sum(r[4].get(S, [0.0])) / max(len(r[4].get(S, [])), 1):.4f} "
                          f"({len(r[4].get(S, []))})" for r in results[m]) for m in args.modes]
        print(f"  {f'S {S}':45s} " + '  |  '.join(cells))
    for label, i in (('step 0 loss', 5), ('peak memory over the steps, B', 6)):
        cells = ['/'.join(repr(r[i]) for r in results[m]) for m in args.modes]
        print(f"  {label:45s} " + '  |  '.join(cells))
    print(smi)


if __name__ == '__main__':
    main()
