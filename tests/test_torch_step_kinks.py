"""The port's training-step gradients against the JAX package's on batch seeds 0-9,
with the two frameworks' branch choices at the gradient's kinks made the same.

The step's gradient is discontinuous in two places: a LeakyReLU takes the other
slope where its pre-activation crosses zero, and a trilinear sampler takes another
cell (nudged floor, clamped fraction, triangular plane weight, zero padding) where a
sample coordinate crosses a voxel knot. In float32 the two frameworks round
differently, so a pre-activation or coordinate within their rounding difference of a
kink takes the other branch in one of them, and the weight gradients behind it move
by up to a few percent. ``test_torch_train_step.py`` compares the step on a batch
without such a point; this file covers the batches that have one.

The JAX step records, in the same jitted run that yields its gradients, the input
of every LeakyReLU backward and every sample coordinate. The port then runs its own
forward and backward with the slopes taken from the signs of the JAX pre-activations
and the coordinate values taken from the JAX coordinates (their gradients still flow
through the port's own arithmetic). The test checks that what was imposed lies
within the rounding band (every pre-activation and coordinate agrees closely and
only a handful of slopes differ), and that every gradient leaf then matches at the
tolerances of ``test_torch_train_step.py``. Seeds 5-9 run in
``test_torch_step_kinks_seeds.py``, the label options in
``test_torch_step_kinks_options.py`` (each file compiles its own instrumented
step; split so that no file is the suite's longest).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as flax_nn
import torch

import acquisition_focus_tpu.ops.resample as jres
from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu.models.localization import space_to_depth
import acquisition_focus_tpu_torch.models.hybrid_unet as thybrid
import acquisition_focus_tpu_torch.models.localization as tloc
import acquisition_focus_tpu_torch.ops.resample as tres
from acquisition_focus_tpu_torch.engine import train as ttrain
from test_torch_train_step import (  # noqa: F401 (few_threads: a fixture)
    SKINNY, all_pairs, few_threads, is_pre_norm_bias, leaf_scales, make_batch, to_np,
    torch_batch, torch_setup)

SEEDS = range(5)        # seeds 5-9: test_torch_step_kinks_seeds.py
ACT_AGREE = 1e-3       # max |JAX - port| of a pre-activation record
COORD_AGREE = 1e-4     # max |JAX - port| of a sample coordinate, in voxels
MAX_SLOPE_FLIPS = 5    # per seed, both microbatches


class _Recorder:
    """JAX side: LeakyReLU backward inputs and sample coordinates, appended by
    host callbacks while the jitted gradient runs."""

    def __init__(self):
        self.acts, self.coords = [], []
        leaky = jax.custom_vjp(lambda x: jnp.where(x >= 0, x, 0.01 * x))

        def fwd(x):
            return leaky(x), x

        def bwd(x, g):
            jax.debug.callback(lambda v: self.acts.append(np.array(v)), x)
            return (jnp.where(x >= 0, g, 0.01 * g),)

        leaky.defvjp(fwd, bwd)
        self.leaky = leaky

    def leaky_relu(self, x, negative_slope=0.01):
        assert negative_slope == 0.01
        return self.leaky(x)

    def to_vox(self, s, n, orig):
        out = orig(s, n)
        jax.debug.callback(lambda v: self.coords.append(np.array(v)), out)
        return out


class _Imposer:
    """Port side: records each LeakyReLU input and sample coordinate in call order
    and, when given, replaces the slope choice or the coordinate value."""

    def __init__(self, orig_to_vox):
        self.orig_to_vox = orig_to_vox
        self.acts, self.coords = [], []
        self.slopes, self.coord_values = None, None

    def leaky_relu(self, x, negative_slope=0.01):
        i = len(self.acts)
        self.acts.append(x.detach().clone())
        pos = self.slopes[i] if self.slopes is not None else x >= 0
        return _LeakyWithSlopes.apply(x, pos, negative_slope)

    def to_vox(self, s, n):
        out = self.orig_to_vox(s, n)
        i = len(self.coords)
        self.coords.append(out.detach().clone())
        if self.coord_values is not None:
            out = out + (self.coord_values[i] - out).detach()
        return out


class _LeakyWithSlopes(torch.autograd.Function):
    """LeakyReLU whose backward slope is 1 where ``pos`` and ``slope`` elsewhere."""

    @staticmethod
    def forward(ctx, x, pos, slope):
        ctx.save_for_backward(pos)
        ctx.slope = slope
        return torch.where(x >= 0, x, x * slope)

    @staticmethod
    def backward(ctx, g):
        pos, = ctx.saved_tensors
        return torch.where(pos, g, g * ctx.slope), None, None


def _jax_layouts(x):
    """(JAX-layout view of a port NC... array, flat port index of each element):
    channels-last, and for 5D arrays with even sides also the JAX localization
    net's space-to-depth blocking."""
    idx = np.arange(x.size).reshape(x.shape)
    last = lambda a: np.moveaxis(a, 1, -1)
    out = [(last(x), last(idx))]
    if x.ndim == 5 and all(s % 2 == 0 for s in x.shape[2:]):
        s2d = lambda a: np.asarray(space_to_depth(jnp.asarray(last(a))))
        out.append((s2d(x), s2d(idx)))
    return out


def _jax_signs(x, jax_acts):
    """The JAX record that matches port pre-activation ``x``: (max |difference|,
    JAX values and slope choices in the port's layout)."""
    best = (np.inf, None)
    for ref in jax_acts:
        for view, idx in _jax_layouts(x):
            if ref.shape == view.shape:
                d = float(np.abs(ref - view).max())
                if d < best[0]:
                    vals = np.empty(x.size, np.float32)
                    vals[idx.ravel()] = ref.ravel()
                    best = (d, vals.reshape(x.shape))
    return best


def _nearest(x, refs):
    cands = [(float(np.abs(r - x).max()), r) for r in refs if r.shape == x.shape]
    return min(cands, key=lambda t: t[0]) if cands else (np.inf, None)


# the unpatched samplers, for a hook installed while another fixture's hooks are
_ORIGINALS = dict(jres_to_vox=jres._to_vox, tres_to_vox=tres._to_vox)


def _instrumented(options):
    """Instrumented JAX gradient of ``options``' spec (jitted once for all its
    seeds) and the port's hooks. JAX's jit caches are cleared on both sides, so
    neither an earlier trace nor the instrumented one leaks across tests."""
    jax.clear_caches()
    rec = _Recorder()
    imp = _Imposer(_ORIGINALS['tres_to_vox'])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, 'leaky_relu', rec.leaky_relu)
        mp.setattr(jres, '_to_vox', functools.partial(rec.to_vox,
                                                      orig=_ORIGINALS['jres_to_vox']))
        mp.setattr(tloc, 'leaky_relu', imp.leaky_relu)
        mp.setattr(thybrid, 'leaky_relu', imp.leaky_relu)
        mp.setattr(tres, '_to_vox', imp.to_vox)

        spec_j = jtrain.StageSpec(**options)
        unet_j, atms_j = jtrain.make_models(spec_j)
        up, ap = jtrain.init_params(spec_j, jax.random.key(0))

        def loss_fn(params, micro):
            return jtrain.forward(spec_j, unet_j, params[0], atms_j, params[1], micro,
                                  None, train=True)[0]

        yield dict(rec=rec, imp=imp, grad_fn=jax.jit(jax.grad(loss_fn)), params=(up, ap),
                   params_np=(to_np(up), to_np(ap)), spec=ttrain.StageSpec(**options))
    jax.clear_caches()


@pytest.fixture(scope='module')
def setup():
    yield from _instrumented(SKINNY)




def _jax_step_grads(setup, batch):
    """Mean microbatch gradients, plus each microbatch's records."""
    rec, grads, records = setup['rec'], [], []
    for i in range(setup['spec'].num_grad_accum_steps):
        rec.acts.clear()
        rec.coords.clear()
        grads.append(setup['grad_fn'](setup['params'],
                                      {k: jnp.asarray(v[i]) for k, v in batch.items()}))
        jax.effects_barrier()
        records.append((list(rec.acts), list(rec.coords)))
    mean = jax.tree_util.tree_map(lambda *g: sum(np.asarray(x) for x in g) / len(g),
                                  *grads)
    return mean, records


def _port_step_grads(setup, batch, imposed=None):
    """The port's mean microbatch gradients, as train_step forms them, optionally
    with per-microbatch (slopes, coordinate values) imposed; plus its records."""
    imp, spec = setup['imp'], setup['spec']
    unet, atms, _, _ = torch_setup(spec, *setup['params_np'])
    tb = torch_batch(batch)
    records = []
    for i in range(spec.num_grad_accum_steps):
        imp.acts, imp.coords = [], []
        imp.slopes, imp.coord_values = imposed[i] if imposed else (None, None)
        loss, _ = ttrain.forward(spec, unet, atms, {k: v[i] for k, v in tb.items()})
        (loss / spec.num_grad_accum_steps).backward()
        records.append(([a.numpy() for a in imp.acts], [c.numpy() for c in imp.coords]))
    imp.slopes, imp.coord_values = None, None
    return dict(unet=unet, atms=atms), records


def _check_aligned(setup, seed):
    """The port's gradients with JAX's branch choices imposed: every leaf at the
    tolerances of ``test_torch_train_step.py``."""
    batch = make_batch(setup['spec'], np.random.default_rng(seed))
    grads_j, jax_records = _jax_step_grads(setup, batch)
    _, port_records = _port_step_grads(setup, batch)

    imposed, flips = [], 0
    for (acts, coords), (jax_acts, jax_coords) in zip(port_records, jax_records):
        slopes, values = [], []
        for x in acts:
            dist, ref = _jax_signs(x, jax_acts)
            assert dist <= ACT_AGREE, (x.shape, dist)
            flips += int(((ref >= 0) != (x >= 0)).sum())
            slopes.append(torch.from_numpy(ref >= 0))
        for c in coords:
            dist, ref = _nearest(c, jax_coords)
            assert dist <= COORD_AGREE, (c.shape, dist)
            values.append(torch.from_numpy(ref))
        imposed.append((slopes, values))
    assert flips <= MAX_SLOPE_FLIPS, flips

    d, _ = _port_step_grads(setup, batch, imposed)
    d['grads_j'] = grads_j
    scales = leaf_scales(d)
    top = max(scales.values())
    for name, ref, p in all_pairs(d, 'grad'):
        got = p.grad.numpy()
        if is_pre_norm_bias(name):
            assert max(np.abs(got).max(), np.abs(ref).max()) <= 1e-5 * top, name
            continue
        np.testing.assert_allclose(got / scales[name], ref / scales[name], atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize('seed', SEEDS)
def test_grads_match_with_kink_branches_aligned(setup, seed):
    _check_aligned(setup, seed)
