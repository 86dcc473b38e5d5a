"""Device ms per step of the kernels launched inside the forwards of the views'
affine transform modules (their localization nets and heads), in the step's
forward and in any recompute of it."""

RANGE = 'atm_fwd'


def ranges(models):
    return [(RANGE, m) for m in models['atms'].modules()
            if type(m).__name__ == 'AffineTransformModule']


def read(run):
    t = run.trace
    if t is None:
        return None
    us = t.device_us_in(RANGE)
    return us / 1e3 / t.n_steps if us else None
