"""The (E)Pix2Vox merger's conv blocks against their roofline: the bound computed
from the shapes of each forward call of a merger conv (2 B Co Ci 27 D H W
operations at the TF32 peak; input, weight and output each moved once, at
float32) over the device time of every kernel their forwards launched."""

from benchmark.metrics._roofline import bound_s

RANGE = 'p2v_merge_fwd'
FLOAT32_BYTES = 4


def ranges(models):
    return [(RANGE, m) for name, m in models['recon'].named_modules()
            if name.startswith('merger.m') and name.endswith('_conv')]


def read(run):
    t = run.trace
    if t is None:
        return None
    bound = 0.0
    for c in t.calls:
        if c.range != RANGE or not c.main_thread:
            continue
        (xs, _, _), (ys, _, _) = c.inputs[0], c.output[0]
        B, ci, co, voxels = xs[0], xs[1], ys[1], xs[2] * xs[3] * xs[4]
        flops = 2.0 * B * co * ci * 27 * voxels
        nbytes = FLOAT32_BYTES * (B * ci * voxels + co * ci * 27 + B * co * voxels)
        bound += bound_s(flops, nbytes, 'tf32')
    us = t.device_us_in(RANGE)
    if not bound or not us:
        return None
    return 100.0 * bound / (us * 1e-6)
