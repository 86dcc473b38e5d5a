"""The port's training step against the JAX package's, on the CPU in float32.

Both frameworks start from the same params (flax init converted with
``acquisition_focus_tpu_torch.convert``) and the same numpy batch, with augmentation
off (jax.random and torch draw different numbers) and non-identity view affines
(off the voxel knots). The skinny spec keeps the prescan at 32^3 so the locnet's
last instance norm sees 2^3 voxels: at 16^3 it normalizes a single voxel to zero
and every locnet conv gradient vanishes.

The step's gradient is discontinuous at LeakyReLU zeros and at the samplers' voxel
knots. Where a pre-activation or a sample coordinate lies within the two
frameworks' float32 rounding difference of such a kink, the two take different
branches, which moves the weight gradients behind it by up to a few percent.
BATCH_SEED is a batch with no point in that band (of seeds 0-9, 4 and 7 are such
batches). ``test_torch_step_kinks.py`` and ``test_torch_step_kinks_seeds.py`` cover
seeds 0-9 with the branches aligned. The label options' steps are held in
``test_torch_step_options.py`` and ``test_torch_step_options_both.py``, whose
JAX compiles would make one file the longest of the suite.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from acquisition_focus_tpu.engine import optimizers as jopt
from acquisition_focus_tpu.engine import runner as jrunner
from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu.engine.config import DEFAULTS
from acquisition_focus_tpu_torch.convert import (
    atm_state_dicts, load_flax_params, unet_state_dict)
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.optimizers import (
    make_reconstruction_optimizer, make_transform_optimizer)
from acquisition_focus_tpu_torch.engine.runner import spec_from_config

SKINNY = dict(
    n_views=2, num_classes=3, n_active_views=2, view_optimization_mode='opt-all',
    use_affine_theta=True,
    hires_fov_mm=(24.0, 24.0, 24.0), hires_fov_vox=(16, 16, 16),
    slice_fov_mm=(24.0, 24.0, 1.5), slice_fov_vox=(16, 16, 1),
    prescan_fov_mm=(24.0, 24.0, 24.0), prescan_fov_vox=(32, 32, 32),
    num_grad_accum_steps=2, compute_dtype='float32', augment_input=False,
    base_features=(2, 4, 4, 8), locnet_width=2)
LR, UPE, EPOCHS = 1e-3, 2, 8
BATCH_SEED = 4


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """The port's side of these tests is many small ops: with several test workers
    on one machine, torch's default of one intra-op thread per core oversubscribes
    the cores and slows every worker (``test_torch_runner.py`` does the same)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def view_affines(rng, n_views, B):
    """(V, B, 4, 4) rotations by 6-17 degrees + small offsets: off the knots."""
    out = np.zeros((n_views, B, 4, 4), np.float32)
    for v in range(n_views):
        for b in range(B):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            ang = rng.uniform(0.1, 0.3)
            k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            out[v, b, :3, :3] = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
            out[v, b, :3, 3] = rng.uniform(-0.1, 0.1, 3)
            out[v, b, 3, 3] = 1.0
    return out


def make_batch(spec, rng, B=1):
    S = spec.hires_fov_vox[0]
    accum = spec.num_grad_accum_steps
    return {
        'label': rng.integers(0, spec.num_classes, (accum, B, S, S, S)).astype(np.int32),
        'nii_affine': np.broadcast_to(np.diag([1.5, 1.5, 1.5, 1.0]),
                                      (accum, B, 4, 4)).astype(np.float32),
        'view_affines': np.stack([view_affines(rng, spec.n_views, B)
                                  for _ in range(accum)]),
    }


def torch_setup(spec, up_np, ap_np):
    unet, atms = ttrain.make_models(spec, 'cpu')
    load_flax_params(unet, atms, up_np, ap_np)
    r_opt = make_reconstruction_optimizer(unet.parameters(), LR, UPE)
    t_opt = make_transform_optimizer(atms.parameters(), LR, EPOCHS, UPE)
    return unet, atms, r_opt, t_opt


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def to_np(tree):
    return jax.tree_util.tree_map(np.array, tree)   # copies: train_step donates


LABEL_OPTIONS = {
    'binarized': dict(use_binarized_labels=True),
    'lv_only': dict(optimize_lv_only=True),
    'binarized_lv_only': dict(use_binarized_labels=True, optimize_lv_only=True),
}


def run_step_pair(options, batch=None, jax_grads=True):
    """One JAX and one torch train_step from the same params and batch (``None``:
    ``make_batch`` from BATCH_SEED), plus (``jax_grads``) the JAX step's gradients
    (mean over microbatches, as train_step forms them)."""
    spec_j = jtrain.StageSpec(**options)
    spec_t = ttrain.StageSpec(**options)
    if batch is None:
        batch = make_batch(spec_j, np.random.default_rng(BATCH_SEED))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    unet_j, atms_j = jtrain.make_models(spec_j)
    up, ap = jtrain.init_params(spec_j, jax.random.key(0))
    up_np, ap_np = to_np(up), to_np(ap)

    def loss_fn(params, micro):
        return jtrain.forward(spec_j, unet_j, params[0], atms_j, params[1], micro,
                              None, train=True)[0]

    grads_j = None
    if jax_grads:
        grad_fn = jax.jit(jax.grad(loss_fn))
        accum = spec_j.num_grad_accum_steps
        grads = [grad_fn((up, ap), {k: v[i] for k, v in jb.items()}) for i in range(accum)]
        grads_j = jax.tree_util.tree_map(lambda *g: sum(np.asarray(x) for x in g) / accum,
                                         *grads)

    r_opt = jopt.make_reconstruction_optimizer(LR, UPE)
    t_opt = jopt.make_transform_optimizer(LR, EPOCHS, UPE)
    # train_step's rng only feeds augmentation, which is off
    new_up, new_ap, _, _, metrics_j, _ = jtrain.train_step(
        spec_j, unet_j, atms_j, r_opt, t_opt, up, ap, r_opt.init(up), t_opt.init(ap),
        jb, jax.random.key(0))

    unet, atms, r, t = torch_setup(spec_t, up_np, ap_np)
    metrics_t = ttrain.train_step(spec_t, unet, atms, r, t, torch_batch(batch))
    return dict(spec=spec_t, loss_j=float(metrics_j['loss']),
                dice_j=np.asarray(metrics_j['dice']), metrics_t=metrics_t,
                grads_j=grads_j, old_up=up_np, old_ap=ap_np,
                new_up=to_np(new_up), new_ap=to_np(new_ap), unet=unet, atms=atms)


@pytest.fixture(scope='module')
def step_pair():
    return run_step_pair(SKINNY)


def unet_pairs(tree, module):
    """(name, JAX leaf converted to the torch layout, torch param)."""
    ref = unet_state_dict(tree)
    params = dict(module.named_parameters())
    return [(k, ref[k].numpy(), params[k]) for k in params]


def atm_pairs(tree, atms):
    out = []
    for v, (ref, mod) in enumerate(zip(atm_state_dicts(tree), atms)):
        for k, p in mod.named_parameters():
            out.append((f'view{v}.{k}', ref[k].numpy(), p))
    return out


def is_pre_norm_bias(name):
    """Conv biases that feed an instance norm: their exact gradient is zero, and
    both frameworks keep only rounding noise of it."""
    return name.endswith('conv.bias') or ('locnet.convnet' in name
                                          and name.endswith('.bias'))


def leaf_scales(d):
    """Per-leaf max |grad| of the JAX step."""
    return {n: float(np.abs(ref).max()) for n, ref, _ in all_pairs(d, 'grad')}


def all_pairs(d, which):
    up = d['grads_j'][0] if which == 'grad' else d['new_up']
    ap = d['grads_j'][1] if which == 'grad' else d['new_ap']
    return unet_pairs(up, d['unet']) + atm_pairs(ap, d['atms'])


def test_loss_matches(step_pair):
    d = step_pair
    loss_t = float(d['metrics_t']['loss'])
    assert np.isfinite(loss_t)
    np.testing.assert_allclose(loss_t, d['loss_j'], rtol=1e-5)


def test_dice_matches(step_pair):
    d = step_pair
    np.testing.assert_allclose(d['metrics_t']['dice'].numpy(), d['dice_j'],
                               atol=1e-6, equal_nan=True)


def test_every_grad_leaf_matches(step_pair):
    """atol 1e-4 after dividing each leaf by its max magnitude; the pre-norm conv
    biases, whose exact gradient is zero, within 1e-5 of the largest leaf's max in
    both frameworks."""
    scales = leaf_scales(step_pair)
    top = max(scales.values())
    for name, ref, p in all_pairs(step_pair, 'grad'):
        assert p.grad is not None, name
        got = p.grad.numpy()
        if is_pre_norm_bias(name):
            assert max(np.abs(got).max(), np.abs(ref).max()) <= 1e-5 * top, name
            continue
        np.testing.assert_allclose(got / scales[name], ref / scales[name], atol=1e-4,
                                   err_msg=name)


def test_updated_params_match(step_pair):
    """atol 1e-5 wherever |grad| > 1e-3 of the leaf max: Adam's first step is
    sign-like, so near-zero gradients may step either way."""
    grads = {n: ref for n, ref, _ in all_pairs(step_pair, 'grad')}
    scales = leaf_scales(step_pair)
    n_checked = 0
    for name, ref, p in all_pairs(step_pair, 'param'):
        if is_pre_norm_bias(name):
            continue
        sel = np.abs(grads[name]) > 1e-3 * scales[name]
        np.testing.assert_allclose(p.detach().numpy()[sel], ref[sel], atol=1e-5,
                                   err_msg=name)
        n_checked += int(sel.sum())
    assert n_checked > 0


def test_params_moved(step_pair):
    """Every trainable leaf (locnets included under opt-all) took a step."""
    old = {n: ref for n, ref, _ in unet_pairs(step_pair['old_up'], step_pair['unet'])
           + atm_pairs(step_pair['old_ap'], step_pair['atms'])}
    for name, _, p in all_pairs(step_pair, 'param'):
        assert not np.array_equal(p.detach().numpy(), old[name]), name


def label_option_checks():
    """The checks of the default step above, by name: ``test_torch_step_options.py``
    and ``test_torch_step_options_both.py`` run them under the label options."""
    return {'loss': test_loss_matches, 'dice': test_dice_matches,
            'updated_params': test_updated_params_match, 'params_moved': test_params_moved}


def test_frozen_views_bit_unchanged():
    """opt-current-fix-previous: only the last active view trains; the frozen
    view's params (and the inactive view's) stay bit-identical through AdamW's
    decoupled weight decay."""
    spec = ttrain.StageSpec(**dict(SKINNY, n_views=3, n_active_views=2,
                                   view_optimization_mode='opt-current-fix-previous'))
    torch.manual_seed(0)
    unet, atms = ttrain.make_models(spec, 'cpu')
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(0))
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in atms]
    r_opt = make_reconstruction_optimizer(unet.parameters(), LR, UPE)
    t_opt = make_transform_optimizer(atms.parameters(), LR, EPOCHS, UPE)
    batch = torch_batch(make_batch(spec, np.random.default_rng(1)))
    for _ in range(2):
        ttrain.train_step(spec, unet, atms, r_opt, t_opt, batch)
    for v in (0, 2):
        for k, val in atms[v].state_dict().items():
            assert torch.equal(val, before[v][k]), (v, k)
    assert any(not torch.equal(val, before[1][k])
               for k, val in atms[1].state_dict().items())


def test_augmented_step_runs_and_learns():
    """Augmentation on (torch.Generator draws): finite losses that fall."""
    spec = ttrain.StageSpec(**dict(SKINNY, augment_input=True))
    unet, atms = ttrain.make_models(spec, 'cpu')
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(0))
    r_opt = make_reconstruction_optimizer(unet.parameters(), LR, UPE)
    t_opt = make_transform_optimizer(atms.parameters(), LR, EPOCHS, UPE)
    batch = torch_batch(make_batch(spec, np.random.default_rng(2)))
    gen = torch.Generator().manual_seed(0)
    losses = [float(ttrain.train_step(spec, unet, atms, r_opt, t_opt, batch, gen)['loss'])
              for _ in range(4)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_stage_spec_fields_match_jax():
    names = [f.name for f in dataclasses.fields(jtrain.StageSpec)]
    assert names == [f.name for f in dataclasses.fields(ttrain.StageSpec)]
    for mode in ('opt-all', 'opt-current-fix-previous', 'opt-none'):
        kw = dict(SKINNY, view_optimization_mode=mode)
        np.testing.assert_array_equal(ttrain.StageSpec(**kw).view_train_mask(),
                                      jtrain.StageSpec(**kw).view_train_mask())


@pytest.mark.parametrize('override', [dict(model_type='epix2vox')])
def test_unported_options_refused(override):
    """Options whose code is not ported raise in make_models instead of running
    without effect: an unknown ``model_type``."""
    with pytest.raises(NotImplementedError):
        ttrain.make_models(ttrain.StageSpec(**dict(SKINNY, **override)), 'cpu')


@pytest.mark.parametrize('override', [
    dict(theta_source='cached'), dict(slice_fov_vox=(8, 8, 1)),
    dict(rotate_slice_to_min_principle=True), dict(atm_remat=True), dict(unet_remat=True),
    dict(decoder_save_names=('conv_out',))])
def test_ported_options_build_and_step(override):
    """The options this port once refused: a cached-theta step (thetas from the
    batch, no locnet, no transform update), slices upsampled to the hires
    in-plane grid, slices turned to their content's min-inertia axis, and the
    recompute switches (``test_torch_recompute.py``); each builds and takes a
    finite step."""
    spec = ttrain.StageSpec(**dict(SKINNY, **override))
    unet, atms = ttrain.make_models(spec, 'cpu')
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(0))
    r_opt = make_reconstruction_optimizer(unet.parameters(), LR, UPE)
    t_opt = make_transform_optimizer(atms.parameters(), LR, EPOCHS, UPE)
    batch = make_batch(spec, np.random.default_rng(0))
    if spec.theta_source == 'cached':
        batch['thetas'] = np.broadcast_to(view_affines(np.random.default_rng(1), 2, 1),
                                          (2, 2, 1, 4, 4)).copy()
    before = [p.detach().clone() for p in atms.parameters()]
    metrics = ttrain.train_step(spec, unet, atms, r_opt, t_opt, torch_batch(batch))
    assert np.isfinite(float(metrics['loss']))
    frozen = all(torch.equal(a, b) for a, b in zip(before, atms.parameters()))
    assert frozen == (spec.theta_source == 'cached')
    assert t_opt[1].last_epoch == (0 if spec.theta_source == 'cached' else 1)


def test_spec_from_config_matches_jax():
    """The slice's entry: spec_from_config(DEFAULTS, 6, 3), field for field."""
    tj = jrunner.spec_from_config(DEFAULTS, 6, 3)
    tt = spec_from_config(DEFAULTS, 6, 3)
    assert dataclasses.asdict(tj) == dataclasses.asdict(tt)
    assert tt.use_pallas_conv3d == 'fwd' and tt.dtype == torch.bfloat16


def test_full_width_models_build():
    """The default configuration's modules construct at reference widths."""
    unet, atms = ttrain.make_models(spec_from_config(DEFAULTS, 6, 3), 'cpu')
    assert len(atms) == 3
    assert unet.seg_head.weight.shape == (6, 48, 1, 1, 1)
    assert unet.decoder[0].a_conv.weight.shape == (48, 96, 3, 3, 3)


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax, flax or optax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import acquisition_focus_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
