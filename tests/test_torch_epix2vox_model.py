"""The port's (E)Pix2Vox at its fixed 128^3 against the JAX package, on the CPU in
float32 with converted flax params: one whole-model forward through the training
step's path (slices -> interface -> ``EPix2VoxModel128`` -> occupancy -> loss),
the gradient of that loss with respect to every parameter and to the slices, the
port's ``train_step`` on the same batch, the model without its merger, and the
refiner, which neither package's model calls.

The JAX package's ``train_step`` takes ~110 s here at this size, so the step is
held on its loss and Dice against the JAX loss (the step's loss is the loss
before the update), and on the update it makes; the gradient that update starts
from is held against JAX's in ``test_whole_model_gradients_match``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from acquisition_focus_tpu.engine import losses as jlosses
from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu.models import epix2vox as J
from acquisition_focus_tpu_torch.convert import epix2vox_state_dict, load_flax_params
from acquisition_focus_tpu_torch.data import make_heart_phantom
from acquisition_focus_tpu_torch.engine import losses as tlosses
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.optimizers import (
    make_epix2vox_optimizer, make_transform_optimizer)
from acquisition_focus_tpu_torch.models import epix2vox as P

from test_torch_epix2vox import check_block
from test_torch_train_step import view_affines

# the JAX runner's EPix2Vox stage at the single-stage protocol (fixed views,
# binarized labels: a binarized dataset's 2 classes), cut to B 1 x accum 1 and a
# narrow locnet
SPEC = dict(
    n_views=2, num_classes=2, n_active_views=2, view_optimization_mode='opt-none',
    use_affine_theta=False, use_binarized_labels=True, prescan_fov_vox=(32,) * 3,
    locnet_width=2, num_grad_accum_steps=1, compute_dtype='float32',
    augment_input=False, model_type='hybrid-EPix2Vox')


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_forward():
    """The JAX package's params, its slices of a 128^3 phantom batch with views
    rotated off the voxel knots, and the loss of its ``forward``'s (E)Pix2Vox
    branch on them (``train.forward``, interface -> model -> binarized
    Dice + CE) with its gradient with respect to the model's params and to the
    slices."""
    spec = jtrain.StageSpec(**SPEC)
    rng = np.random.default_rng(0)
    label = (make_heart_phantom((128,) * 3, seed=0)[0] > 0).astype(np.int32)
    batch = {'label': label[None, None],
             'nii_affine': np.diag([1.5, 1.5, 1.5, 1.0]).astype(np.float32)[None, None],
             'view_affines': view_affines(rng, 2, 1)[None]}
    unet, atms = jtrain.make_models(spec)
    up, ap = jtrain.init_params(spec, jax.random.key(0))

    @jax.jit
    def model_input(a, b):
        onehot = jax.nn.one_hot(b['label'], spec.num_classes, axis=1, dtype=jnp.float32)
        slices, grid_affines, *_ = jtrain.extract_view_slices(
            spec, atms, a, onehot, b['nii_affine'], b['view_affines'])
        return jtrain.assemble_model_input(spec, slices, grid_affines)[0], onehot

    def loss_fn(u, b_input, target):
        occupancy = unet.apply(u, J.epix2vox_interface_input(b_input, spec.n_views))
        y_hat = jlosses.binarize_onehot(J.epix2vox_interface_output(occupancy))
        return jlosses.dice_ce_loss(y_hat, target), y_hat

    micro = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    b_input, onehot = model_input(ap, micro)
    target = jlosses.binarize_onehot(onehot)
    (loss, logits), (g_params, g_input) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(up, b_input, target)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(batch=batch, up=np_tree(up), ap=np_tree(ap), loss=float(loss),
                logits=np.asarray(logits), b_input=np.asarray(b_input),
                target=np.asarray(target), g_input=np.asarray(g_input),
                g_params=epix2vox_state_dict(np_tree(g_params)),
                dice=np.asarray(jtrain._metrics_from_logits(spec, logits, target)[1]))


def port_models(jf):
    spec = ttrain.StageSpec(**SPEC)
    unet, atms = ttrain.make_models(spec, 'cpu')
    load_flax_params(unet, atms, jf['up'], jf['ap'])
    return spec, unet, atms


def test_whole_model_forward_matches(jax_forward):
    """Slices, the occupancy stack and the loss of one forward: measured gaps
    1.7e-5 (b_input, the float32 trilinear slicing), ~6e-5 (logits, in [0, 1]; a
    78M-parameter float32 forward) and ~1e-6 (loss, relative)."""
    jf = jax_forward
    spec, unet, atms = port_models(jf)
    batch = {k: torch.from_numpy(np.array(v[0])) for k, v in jf['batch'].items()}
    with torch.no_grad():
        loss, aux = ttrain.forward(spec, unet, atms, batch)
    assert aux['logits'].shape == (1, 2, 128, 128, 128)
    np.testing.assert_allclose(aux["b_input"].numpy(), jf["b_input"], atol=1e-4)
    np.testing.assert_allclose(aux['logits'].numpy(), jf['logits'], atol=2e-4)
    assert abs(float(loss) - jf['loss']) <= 1e-5 * abs(jf['loss'])


def test_train_step_matches_the_jax_loss(jax_forward):
    """One ``train_step`` with the (E)Pix2Vox optimizer: its loss and Dice are the
    JAX package's (measured ~1e-6 relative; Dice within one voxel's flip), and
    the update moves the encoder and decoder, leaves the merger (its softmax over
    the one fused view has no gradient) and the frozen ATMs alone, and stays
    finite."""
    jf = jax_forward
    spec, unet, atms = port_models(jf)
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    atms_before = [p.detach().clone() for p in atms.parameters()]
    recon = make_epix2vox_optimizer(unet, updates_per_epoch=2)
    trans = make_transform_optimizer(atms.parameters(), 1e-3, 40, 2)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jf['batch'].items()}
    metrics = ttrain.train_step(spec, unet, atms, recon, trans, batch)
    assert abs(float(metrics['loss']) - jf['loss']) <= 1e-5 * abs(jf['loss'])
    np.testing.assert_allclose(metrics['dice'].numpy(), jf['dice'], atol=1e-4)
    moved = {n for n, p in unet.named_parameters() if not torch.equal(p, before[n])}
    assert all(torch.isfinite(p).all() for p in unet.parameters())
    assert 'encoder.resnet.conv1.weight' in moved and 'decoder.up0.weight' in moved
    assert not any(n.startswith('merger.') for n in moved)
    assert all(torch.equal(a, b) for a, b in zip(atms.parameters(), atms_before))
    assert recon[0].state_dict()['state'][0]['step'] == 1


def test_whole_model_gradients_match(jax_forward):
    """The gradient of the training loss with respect to every parameter of the
    model and to the slices, from the JAX package's slices, which the updates of
    both packages start from.

    Where the stem's max pool meets near-ties (the views are binary x255, so its
    window often holds equal values up to rounding), float32 rounding decides
    which input takes the gradient: the port's own float32 gradient is ~50% from
    its float64 one in the stem's parameters and ~36% at the slices. JAX and the
    port round alike there, so they are held closer than that. Measured worst
    gaps, per tensor, as the norm of the difference over the norm of JAX's:
    2.7e-2 in the encoder (tolerance 5e-2), 5.7e-3 in the decoder (1e-2), 2.1e-1
    at the slices (0.3). The absolute 1e-5 (~4e-5 of the whole gradient's norm)
    holds the gradients that are sums which cancel: the single-channel
    cross-view norm's bias (8.2e-5, gap 8.0e-6) and the conv biases ahead of a
    batch-statistics norm (~1e-10: the norm removes them)."""
    jf = jax_forward
    spec, unet, atms = port_models(jf)
    b_input = torch.from_numpy(jf['b_input']).requires_grad_()
    y_hat = tlosses.binarize_onehot(P.epix2vox_interface_output(
        unet(P.epix2vox_interface_input(b_input, spec.n_views))))
    loss = tlosses.dice_ce_loss(y_hat, torch.from_numpy(jf['target']))
    loss.backward()
    assert abs(float(loss) - jf['loss']) <= 1e-5 * abs(jf['loss'])

    def gap(got, ref):
        return float(np.linalg.norm(got - ref)), float(np.linalg.norm(ref))

    d, n = gap(b_input.grad.numpy(), jf['g_input'])
    assert d <= 0.3 * n, (d, n)
    names = [name for name, _ in unet.named_parameters()]
    assert sorted(names) == sorted(jf['g_params'])
    for name, p in unet.named_parameters():
        d, n = gap(p.grad.numpy(), jf['g_params'][name].numpy())
        rtol = 5e-2 if name.startswith('encoder.') else 1e-2
        assert d <= rtol * n + 1e-5, (name, d, n)
        if name.startswith('merger.'):                  # softmax over one fused view
            assert n == 0.0 and not p.grad.any()


def test_model_without_merger_matches(jax_forward):
    """``use_merger=False`` (the mean of the views' coarse volumes) against the
    JAX model built the same way, from the same params less the merger's:
    measured gap 1.2e-4 on an occupancy in [0, 1] (the mean of two sigmoids
    after a 78M-parameter float32 forward)."""
    jf = jax_forward
    params = {'params': {k: v for k, v in jf['up']['params'].items() if k != 'merger'}}
    views = J.epix2vox_interface_input(jnp.asarray(jf['b_input']), 2)
    want = np.asarray(jax.jit(J.EPix2VoxModel128(2, use_merger=False).apply)(params, views))
    model = P.EPix2VoxModel128(2, use_merger=False)
    model.load_state_dict(epix2vox_state_dict(params))
    with torch.no_grad():
        got = model(P.epix2vox_interface_input(torch.from_numpy(jf['b_input']), 2))
    assert got.shape == (1, 128, 128, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4)


def test_refiner_matches(rng):
    """The refiner, which neither package's model calls, at B 1: its dense layers
    fix the volume at 128^3 (4^3 x 128 = 8192 features; at 16^3 the JAX module's
    reshape fails). Measured gaps ~1e-7 forward, ~1e-6 input gradient."""
    vol = rng.random((1, 128, 128, 128)).astype(np.float32)
    check_block(J.Epix2VoxRefiner(), P.Epix2VoxRefiner(), lambda m, v: m(v), [vol], rng,
                1e-5, 1e-4)
