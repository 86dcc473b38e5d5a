"""Where the default training step's device time goes, by kernel group, on the card.

    python -m acquisition_focus_tpu_torch.profile_step [--modes fwd full] [--rounds 2]

For each round and each ``use_pallas_conv3d`` mode in turn: the default
configuration's step (``spec_from_config(DEFAULTS, 6, 3)``, batch 2 x accum 2,
128^3, bf16) from seed-0 weights on phantom labels, 2 warm-up and 3 timed steps
back to back (host clock, ending in a sync), then one step under
``torch.profiler``. It prints the device milliseconds of that step by kernel
group, the device total, the wall time of the profiled step and the device's idle
share (1 - device total / wall), the port's kernels one by one (device ms and
launches per step), with the card's name and power limit. Needs a
CUDA device; there is no CPU fallback.
"""

import argparse
import re
import subprocess
import time

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
    step = default_step(mode)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    back_to_back = (time.perf_counter() - t0) / 3
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms, kernels = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g, t = group_of(e.name), e.time_range.elapsed_us() / 1e3
            ms[g] = ms.get(g, 0.0) + t
            if g in PORT_GROUPS:
                name = KERNEL_NAME.search(e.name).group(0)
                k_ms, n = kernels.get(name, (0.0, 0))
                kernels[name] = (k_ms + t, n + 1)
    torch.cuda.empty_cache()
    return ms, wall * 1e3, back_to_back * 1e3, kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--modes', nargs='+', default=['fwd', 'full'])
    ap.add_argument('--rounds', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, f"torch {torch.__version__}", flush=True)
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
    print(smi)


if __name__ == '__main__':
    main()
