"""The 128^3 decoder level's 3^3 conv forwards against their roofline: the bound
computed from the shapes of each forward call (2 B Co Ci 27 D H W operations at
the bf16 peak; input, weight and output each moved once, at the input's dtype)
over the device time of every kernel their forwards launched."""

from benchmark.metrics._roofline import bound_s

RANGE = 'dec128_conv_fwd'


def ranges(models):
    return [(RANGE, m) for name, m in models['recon'].named_modules()
            if type(m).__name__ == 'Conv3x3x3' and name.startswith('decoder.0.')]


def read(run):
    t = run.trace
    if t is None:
        return None
    bound = 0.0
    for c in t.calls:
        if c.range != RANGE or not c.main_thread:
            continue
        (xs, dtype, xb), (ys, _, yb) = c.inputs[0], c.output[0]
        if tuple(xs[2:]) != (128, 128, 128):
            continue
        B, ci, co, voxels = xs[0], xs[1], ys[1], xs[2] * xs[3] * xs[4]
        flops = 2.0 * B * co * ci * 27 * voxels
        nbytes = xb + yb + co * ci * 27 * (xb // (B * ci * voxels))
        bound += bound_s(flops, nbytes, 'bfloat16')
    us = t.device_us_in(RANGE)
    if not bound or not us:
        return None
    return 100.0 * bound / (us * 1e-6)
