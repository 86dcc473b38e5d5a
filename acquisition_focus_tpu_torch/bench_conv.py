"""Time K3 (forward and as the input gradient) and K4 against their library calls.

    python -m acquisition_focus_tpu_torch.bench_conv [--repeats 2]

At the decoder's 128^3 level in bf16 (batch 2; Ci 96 -> Co 48 and 48 -> 48): K3
forward against ``F.conv3d``, K3 on the cotangent with the flipped, IO-swapped
weights against ``torch.nn.grad.conv3d_input``, K4 against
``torch.nn.grad.conv3d_weight``; CUDA events, mean of 5 launches after 2 warm-up
ones, each error divided by the float32 reference's max. The quick loop for
kernel work: it builds the kernels and runs in well under a minute, where
``chip_smoke.py`` drives the whole port. Needs a CUDA device.
"""

import argparse
import subprocess

import torch
import torch.nn.functional as F

from acquisition_focus_tpu_torch.ops.kernels.conv3d import conv3d_fwd_cuda, conv3d_wgrad_cuda


def cuda_ms(fn, iters=5):
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


def rel_err(got, ref):
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def bench(ci, co=48):
    x = torch.randn(2, ci, 128, 128, 128, device='cuda').bfloat16()
    g = torch.randn(2, co, 128, 128, 128, device='cuda').bfloat16()
    w = torch.randn(co, ci, 3, 3, 3, device='cuda') / (27 * ci) ** 0.5
    b = torch.randn(co, device='cuda') * 0.1
    wb = w.bfloat16()
    w_t = wb.flip(2, 3, 4).transpose(0, 1)
    zb = torch.zeros(ci, device='cuda')
    errs = (
        rel_err(conv3d_fwd_cuda(x, w, b), F.conv3d(x.float(), wb.float(), b, padding=1)),
        rel_err(conv3d_fwd_cuda(g, w_t, zb),
                torch.nn.grad.conv3d_input(x.shape, wb.float(), g.float(), padding=1)),
        rel_err(conv3d_wgrad_cuda(x, g),
                torch.nn.grad.conv3d_weight(x.float(), w.shape, g.float(), padding=1)))
    rows = (
        ('K3 forward', lambda: conv3d_fwd_cuda(x, w, b),
         lambda: F.conv3d(x, wb, b.bfloat16(), padding=1)),
        ('K3 as dx', lambda: conv3d_fwd_cuda(g, w_t, zb),
         lambda: torch.nn.grad.conv3d_input(x.shape, wb, g, padding=1)),
        ('K4 wgrad', lambda: conv3d_wgrad_cuda(x, g),
         lambda: torch.nn.grad.conv3d_weight(x, w.shape, g, padding=1)),
    )
    for (name, kernel, library), err in zip(rows, errs):
        print(f"  Ci {ci:3d} Co {co}  {name:10s}  kernel {cuda_ms(kernel):.3f} ms  library "
              f"{cuda_ms(library):.3f} ms  err {err:.2e}", flush=True)
    del x, g
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--repeats', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_conv: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for _ in range(args.repeats):
        for ci in (96, 48):
            bench(ci)


if __name__ == '__main__':
    main()
