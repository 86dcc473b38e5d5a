"""Time K1f at the six skip levels, and hold its bits against another checkout's.

    python -m acquisition_focus_tpu_torch.bench_plane [--iters 20]
    PYTHONPATH=DIR python -P acquisition_focus_tpu_torch/bench_plane.py --dump OUT
    python -m acquisition_focus_tpu_torch.bench_plane --compare OUT_A OUT_B

Default: at each skip level (S, F) of the main path (batch 2, bf16, unrounded random
rotations from a seed), K1f for one view (a new (2, F, S^3) volume) and for the
main path's launch, three views into a (2, 6F, S^3) concat buffer at channel 3F:
CUDA-event ms per launch (mean of ``--iters`` after warm-up; it includes the
wrapper's host work) and device ms per launch (``torch.profiler``), beside the
bound (output and planes moved once at 3.35 TB/s).

``--dump OUT``: K1f's one-view outputs at level 0 (S 128, F 16) and level 5 (S 4,
F 256) in float32 and bfloat16 on seeded inputs, saved under OUT. It calls only
``plane_resample_fwd(slices, coefs, S)`` and ``affine_coefficients``, which earlier
checkouts have too, so with ``PYTHONPATH=DIR python -P`` it dumps checkout DIR's
kernel. ``--compare A B`` counts the elements whose bits differ between two dumps.
Needs a CUDA device for the first two.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

LEVELS = ((128, 16), (64, 32), (32, 64), (16, 128), (8, 256), (4, 256))
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate


def rotations(rng, n):
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out[i, :3, :3] = q
        out[i, :3, 3] = rng.uniform(-0.2, 0.2, 3)
    return torch.tensor(out, dtype=torch.float32, device='cuda')


def inputs(S, F, V, dtype, seed):
    """(2, V*F, S, S) planes and (V, 2, 3, 4) coefficients (V = 1: (2, 3, 4))."""
    from acquisition_focus_tpu_torch.ops.kernels import affine_coefficients
    rng = np.random.default_rng(seed)
    slices = torch.tensor(rng.normal(size=(2, V * F, S, S)), dtype=torch.float32,
                          device='cuda').to(dtype)
    coefs = affine_coefficients(rotations(rng, V * 2), (S,) * 3, (S,) * 3)
    return slices, coefs.reshape((V, 2, 3, 4) if V > 1 else (2, 3, 4)).contiguous()


def event_ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Device ms per launch of the K1f kernel over ``iters`` calls of ``fn``. A
    window this short sometimes comes back without its device events; it is then
    profiled again, at most three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and 'plane_fwd' in e.name]
        if len(times) == iters:
            return sum(times) / iters
        print(f"  ({len(times)} of {iters} K1f kernels in the trace: profiling again)",
              flush=True)
    raise RuntimeError(f"expected {iters} K1f kernels in the trace, found {len(times)}")


def bench(iters):
    from acquisition_focus_tpu_torch.ops.kernels.plane_resample import plane_resample_fwd
    print("(S, F)      launch                      event ms   device ms  bound ms", flush=True)
    for S, F in LEVELS:
        for V in (1, 3):
            slices, coefs = inputs(S, F, V, torch.bfloat16, seed=S)
            if V == 1:
                what = f"one view -> (2, {F}, S^3)"
                fn = lambda: plane_resample_fwd(slices, coefs, S)       # noqa: E731
            else:
                buf = torch.empty((2, 6 * F) + (S,) * 3, dtype=torch.bfloat16, device='cuda')
                what = f"3 views -> [:, {3 * F}:] of {6 * F}"
                fn = lambda: plane_resample_fwd(slices, coefs, S, buf, 3 * F)  # noqa: E731
            bound = (slices.numel() + 2 * V * F * S ** 3) * 2 / HBM_BYTES_S * 1e3
            print(f"({S:3d}, {F:3d})  {what:26s}  {event_ms(fn, iters):.4f}     "
                  f"{device_ms(fn, iters):.4f}     {bound:.4f}", flush=True)
        torch.cuda.empty_cache()


DUMPS = [(S, F, dtype) for S, F in (LEVELS[0], LEVELS[-1])
         for dtype in (torch.float32, torch.bfloat16)]


def dump_name(S, F, dtype):
    return f"k1f_S{S}_F{F}_{str(dtype).split('.')[-1]}.pt"


def dump(out_dir):
    import acquisition_focus_tpu_torch
    from acquisition_focus_tpu_torch.ops.kernels.plane_resample import plane_resample_fwd
    print(f"K1f of {Path(acquisition_focus_tpu_torch.__file__).parent}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    for S, F, dtype in DUMPS:
        slices, coefs = inputs(S, F, 1, dtype, seed=S)
        out = plane_resample_fwd(slices, coefs, S)
        torch.save(out.cpu(), out_dir / dump_name(S, F, dtype))
        print(f"  {dump_name(S, F, dtype)}: {tuple(out.shape)}", flush=True)


def compare(a, b):
    """Exit status 1 if any dump differs."""
    differ = False
    for S, F, dtype in DUMPS:
        x, y = (torch.load(d / dump_name(S, F, dtype)) for d in (a, b))
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        n_diff = int((x.view(bits) != y.view(bits)).sum()) if x.shape == y.shape else -1
        print(f"  (S {S}, F {F}) {str(dtype).split('.')[-1]:8s} {x.numel()} elements, "
              f"{n_diff} differ in their bits{'' if n_diff else ': bit-equal'}", flush=True)
        differ |= n_diff != 0
    return int(differ)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--dump', type=Path)
    ap.add_argument('--compare', type=Path, nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        raise SystemExit("bench_plane: no CUDA device")
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.dump:
        return dump(args.dump)
    return bench(args.iters)


if __name__ == '__main__':
    sys.exit(main())
