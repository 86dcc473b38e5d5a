"""The port's (E)Pix2Vox (``acquisition_focus_tpu_torch/models/epix2vox.py``) against
the JAX package's flax modules, on the CPU in float32, block by block with the flax
params converted by ``convert.epix2vox_state_dict``: forward and input gradient of
each part, the parameter count of the whole model, the interface adapters, the
Kaiming init, and the (E)Pix2Vox optimizer against optax. The parts that run at
the model's fixed 128^3 (the whole model, its training step, the refiner) are held
in ``test_torch_epix2vox_model.py``.

Tolerances are on errors divided by the reference's max (``close_scaled``); the
gap measured on the CPU is written beside each.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
import torch

from acquisition_focus_tpu.engine import optimizers as jopt
from acquisition_focus_tpu.models import epix2vox as J
from acquisition_focus_tpu.ops import channel_ops as jch
from acquisition_focus_tpu_torch.convert import epix2vox_state_dict
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.optimizers import make_epix2vox_optimizer
from acquisition_focus_tpu_torch.models import epix2vox as P
from acquisition_focus_tpu_torch.ops import channel_ops as tch


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)


def close_scaled(got, ref, atol):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale, atol=atol)


def randomize(params, rng):
    """Norm scales and biases away from 1 and 0, so the affine part is held too."""
    def leaf(path, x):
        name = path[-1].key
        if name == 'scale':
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
        if name == 'bias':
            return jnp.asarray(rng.normal(0.0, 0.1, x.shape), jnp.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


def check_block(jmod, tmod, tfn, inputs, rng, tol_fwd, tol_grad):
    """Forward and input gradients of a flax module and its port, from the flax
    init (norm scales and biases randomized) converted. ``inputs`` and the
    outputs are in the JAX package's layout; ``tfn(tmod, *inputs)`` applies the
    port's module in that layout (its own layout moves inside).

    Deep blocks accumulate float32 rounding, and their gradients are
    discontinuous at ReLU zeros and max-pool ties: where rounding puts a value
    on the other side of one, float32 itself is far from exact arithmetic. So an
    error over the tolerance passes if it is within the tolerance plus twice the
    gap between the port's float32 and float64 results (which only the JAX
    package's own float32 rounding can explain)."""
    jin = [jnp.asarray(x) for x in inputs]
    params = randomize(jax.jit(jmod.init)(jax.random.key(0), *jin), rng)
    tmod.load_state_dict(epix2vox_state_dict(jax.tree_util.tree_map(np.asarray, params)))

    @jax.jit
    def fwd_bwd(args, cts):
        out, vjp = jax.vjp(lambda *a: jmod.apply(params, *a), *args)
        return out, vjp(cts)

    out_shapes = jax.eval_shape(lambda *a: jmod.apply(params, *a), *jin)
    single = not isinstance(out_shapes, tuple)
    cts = [rng.normal(size=o.shape).astype(np.float32)
           for o in ((out_shapes,) if single else out_shapes)]
    out_j, grads_j = fwd_bwd(jin, jnp.asarray(cts[0]) if single
                             else tuple(jnp.asarray(c) for c in cts))
    outs_j = (out_j,) if single else out_j

    def port(dtype):
        tin = [torch.tensor(x, dtype=dtype).requires_grad_() for x in inputs]
        out_t = tfn(tmod.to(dtype), *tin)
        outs_t = (out_t,) if single else out_t
        torch.autograd.backward(list(outs_t), [torch.tensor(c, dtype=dtype) for c in cts])
        tmod.float()
        return ([o.detach().double().numpy() for o in outs_t],
                [t.grad.double().numpy() for t in tin])

    got = port(torch.float32)
    exact = None
    for kind, tol in (('outputs', tol_fwd), ('gradients', tol_grad)):
        for i, ref in enumerate(outs_j if kind == 'outputs' else grads_j):
            g32, ref = got[kind == 'gradients'][i], np.asarray(ref)
            scale = max(float(np.abs(ref).max()), 1e-6)
            err = float(np.abs(g32 - ref).max()) / scale
            if err <= tol:
                continue
            exact = exact or port(torch.float64)
            gap64 = float(np.abs(g32 - exact[kind == 'gradients'][i]).max()) / scale
            assert err <= tol + 2 * gap64, (kind, i, err, gap64)


def channels_last(tmod, x):
    """Apply a channels-first module to a channels-last tensor."""
    return tmod(x.movedim(-1, 1)).movedim(1, -1)


# ---------------------------------------------------------------- blocks

def test_batch_norm_matches(rng):
    """Current-batch statistics over (N, H, W) per channel (measured gap ~1e-7)."""
    x = rng.normal(1.0, 2.0, (3, 5, 7, 4)).astype(np.float32)
    check_block(J._BatchNorm(), P.BatchNorm(4), channels_last, [x], rng, 1e-5, 1e-5)


def test_batch_norm_in_eval_uses_the_batch(rng):
    """No running statistics: eval normalizes with the batch's own, as the JAX
    package does (queue 3's EPix2Vox eval normalization, mirrored)."""
    bn = P.BatchNorm(3).eval()
    x = T(rng.normal(5.0, 3.0, (4, 3, 6, 6)))
    y = bn(x)
    np.testing.assert_allclose(y.mean((0, 2, 3)).detach().numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(y.var((0, 2, 3), unbiased=False).detach().numpy(), 1.0,
                               atol=1e-3)
    assert not any(b.numel() for b in bn.buffers())


@pytest.mark.parametrize('ci,features,stride,size', [
    (16, 4, 1, 8),      # identity residual
    (8, 4, 1, 8),       # projection: channels change
    (16, 4, 2, 8),      # projection and stride 2, even size: SAME pads (0, 1)
    (16, 4, 2, 7),      # odd size: SAME pads (1, 1)
])
def test_bottleneck_matches(rng, ci, features, stride, size):
    """Forward and input gradient (measured gaps <= 2e-6)."""
    x = rng.normal(size=(2, size, size, ci)).astype(np.float32)
    tmod = P.Bottleneck(ci, features, stride)
    assert hasattr(tmod, 'down') == (ci != 4 * features or stride != 1)
    check_block(J._Bottleneck(features, stride), tmod, channels_last, [x], rng, 1e-5, 1e-4)


def test_resnet50_stem_matches(rng):
    """conv1..layer2 at 32^2 -> 4^2 x 512 (measured gaps ~1e-6 / ~5e-6)."""
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    check_block(J.ResNet50Stem(), P.ResNet50Stem(), channels_last, [x], rng, 1e-5, 1e-4)


@pytest.mark.parametrize('use_epix2vox', [True, False])
def test_encoder_matches(rng, use_epix2vox):
    """The encoder at its fixed 224^2, B 1, V 2: the (B, V, 8, 8, 256) order and,
    with ``use_epix2vox``, the cross-view conv over the view axis (its l4_conv
    transpose). Measured gaps ~2e-6 forward, ~1e-5 input gradient."""
    x = rng.random((1, 2, 224, 224, 3)).astype(np.float32) * 255.0
    check_block(J.Epix2VoxEncoder(2, use_epix2vox), P.Epix2VoxEncoder(2, use_epix2vox),
                lambda m, v: m(v.movedim(-1, 2)), [x], rng, 1e-5, 1e-4)


class MiniDecoder(fnn.Module):
    """The JAX decoder narrowed, from the JAX module's own ``_ConvT`` and
    ``_batch_norm``: (B, V, 4, 4, 8) -> reshape (B*V, 2, 2, 2, 16) -> two 4^3
    stride-2 transposed convs -> 1^3 head."""

    @fnn.compact
    def __call__(self, feats):
        B, V = feats.shape[:2]
        x = feats.reshape(B * V, 2, 2, 2, 16)
        for i, f in enumerate((8, 4)):
            x = J._ConvT(f, (4, 4, 4), strides=(2, 2, 2), padding='SAME', use_bias=False,
                         name=f'up{i}')(x)
            x = fnn.relu(J._batch_norm(x, f'up{i}_bn'))
        vol = fnn.sigmoid(J._ConvT(1, (1, 1, 1), use_bias=False, name='head')(x))
        raw = jnp.concatenate([x, vol], axis=-1)
        S = raw.shape[1]
        return raw.reshape(B, V, S, S, S, raw.shape[-1]), vol.reshape(B, V, S, S, S)


def test_decoder_matches(rng):
    """The decoder's (B*V, 2, 2, 2, C) reshape of channels-last features and its
    transposed convs, narrowed (measured gaps ~1e-7 / ~1e-6)."""
    x = rng.normal(size=(2, 2, 4, 4, 8)).astype(np.float32)

    def apply(m, feats):
        raw, vol = m(feats)
        return raw.movedim(2, -1), vol

    check_block(MiniDecoder(), P.Epix2VoxDecoder(16, (8, 4)), apply, [x], rng, 1e-5, 1e-4)


def test_merger_matches(rng):
    """The context-aware merge at S 8, B 2, V 3 (measured gaps ~1e-7 / ~1e-6)."""
    raw = rng.normal(size=(2, 3, 8, 8, 8, 9)).astype(np.float32)
    coarse = rng.random((2, 3, 8, 8, 8)).astype(np.float32)
    check_block(J.Epix2VoxMerger(), P.Epix2VoxMerger(),
                lambda m, r, c: m(r.movedim(-1, 2), c), [raw, coarse], rng, 1e-5, 1e-4)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize('n_views', [2, 3])
@pytest.mark.parametrize('use_epix2vox', [True, False])
def test_param_count_matches(n_views, use_epix2vox):
    """Equal parameter sets: the refiner has none in either (never called), the
    cross-view conv exists only with ``use_epix2vox`` (78,021,324 at V 2)."""
    shapes = jax.eval_shape(J.EPix2VoxModel128(n_views, use_epix2vox).init,
                            jax.random.key(0), jnp.zeros((1, n_views, 224, 224, 3)))
    flat = {'.'.join(k.key for k in path[1:]): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = P.EPix2VoxModel128(n_views, use_epix2vox)
    n_j = sum(int(np.prod(s)) for s in flat.values())
    assert sum(p.numel() for p in model.parameters()) == n_j
    assert len(list(model.parameters())) == len(flat)
    assert not any(n.startswith('refiner') for n, _ in model.named_parameters())
    if n_views == 2 and use_epix2vox:
        assert n_j == 78_021_324


@pytest.mark.parametrize('n_views', [2, 3])
def test_param_count_without_merger_matches(n_views):
    """``use_merger=False``: both packages build no merger, and the flax params,
    converted, are the port's ``state_dict`` name for name and shape."""
    shapes = jax.eval_shape(J.EPix2VoxModel128(n_views, use_merger=False).init,
                            jax.random.key(0), jnp.zeros((1, n_views, 224, 224, 3)))
    converted = epix2vox_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    model = P.EPix2VoxModel128(n_views, use_merger=False)
    assert {n: t.shape for n, t in converted.items()} == {
        n: p.shape for n, p in model.named_parameters()}
    assert not any(n.startswith('merger') for n in converted)


def test_init_follows_the_reference():
    """Kaiming normal (std sqrt(2 / fan_in)) on convs and transposed convs, zero
    biases, unit norm scales, drawn from the generator; ``train.init_params``
    takes it for the EPix2Vox model and lecun-normal for the ATMs."""
    spec = ttrain.StageSpec(n_views=2, num_classes=6, n_active_views=2,
                            view_optimization_mode='opt-all', use_affine_theta=True,
                            prescan_fov_vox=(32,) * 3, locnet_width=2,
                            model_type='hybrid-EPix2Vox')
    model, atms = ttrain.make_models(spec, 'cpu')
    assert isinstance(model, P.EPix2VoxModel128)
    ttrain.init_params(model, atms, torch.Generator().manual_seed(0))
    w = model.decoder.up0.weight                      # (2048, 512, 4, 4, 4)
    assert abs(w.std().item() / (2.0 / (2048 * 64)) ** 0.5 - 1) < 1e-2
    w = model.encoder.l1_conv.weight                  # (512, 512, 3, 3)
    assert abs(w.std().item() / (2.0 / (512 * 9)) ** 0.5 - 1) < 1e-2
    assert not model.encoder.l1_conv.bias.any()
    assert torch.equal(model.merger.m0_bn.weight, torch.ones(16))
    head = model.decoder.head.weight
    other, _ = ttrain.make_models(spec, 'cpu')
    P.init_weights(other, torch.Generator().manual_seed(0))
    assert torch.equal(other.decoder.head.weight, head)
    ref = P.Epix2VoxRefiner()
    P.init_weights(ref, torch.Generator().manual_seed(0))
    assert abs(ref.fc1.weight.std().item() / 0.01 - 1) < 1e-2


# ---------------------------------------------------------------- interface

class TestInterface:
    """Twins of ``tests/test_epix2vox.py::TestInterface``."""

    def test_input_adapter(self, rng):
        B, V, C, S = 2, 3, 2, 32
        b_input = T(rng.random((B, V * C, S, S)))
        views = P.epix2vox_interface_input(b_input, V)
        assert views.shape == (B, V, 3, 224, 224)
        np.testing.assert_allclose(views[:, :, 0].numpy(), views[:, :, 1].numpy())
        assert float(views.max()) <= 255.0 * float(b_input[:, 1::C].max()) + 1e-3

    def test_output_adapter(self, rng):
        vol = T(rng.random((2, 8, 8, 8)))
        out = P.epix2vox_interface_output(vol)
        assert out.shape == (2, 2, 8, 8, 8)
        np.testing.assert_allclose(out.sum(1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize('S', [32, 128, 256])
def test_interface_input_matches_jax_resize(rng, S):
    """``jax.image.resize(method='linear')`` to 224^2: bilinear with half-pixel
    centers when it grows (S 32, 128: measured 1.8e-7 of 255), antialiased when
    it shrinks (S 256: plain bilinear would be 0.21 off, the antialiased path
    measured ~3e-6)."""
    B, V, C = 2, 2, 3
    b_input = rng.random((B, V * C, S, S)).astype(np.float32)
    ref = np.asarray(J.epix2vox_interface_input(jnp.asarray(b_input), V))
    got = P.epix2vox_interface_input(T(b_input), V).numpy()
    close_scaled(got, np.moveaxis(ref, -1, 2), 2e-5)


def test_channel_ops_match(rng):
    x = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)
    x[:, 3] = x[:, 1]                                   # ties: the first wins
    for name in ('channel_max', 'channel_sum', 'channel_softmax',
                 'channel_log_softmax'):
        np.testing.assert_allclose(getattr(tch, name)(T(x)).numpy(),
                                   np.asarray(getattr(jch, name)(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tch.channel_argmax(T(x)).numpy(),
                                  np.asarray(jch.channel_argmax(jnp.asarray(x))))


# ---------------------------------------------------------------- optimizer

class TinyModel(torch.nn.Module):
    def __init__(self, enc, mer):
        super().__init__()
        self.encoder = torch.nn.Linear(1, 1, bias=False)
        self.merger = torch.nn.Linear(1, 1, bias=False)
        self.encoder.weight = torch.nn.Parameter(T(enc))
        self.merger.weight = torch.nn.Parameter(T(mer))


def test_epix2vox_optimizer_groups_and_milestone():
    model = TinyModel(np.ones((1, 1)), np.ones((1, 1)))
    opt, sched = make_epix2vox_optimizer(model, updates_per_epoch=2)
    assert [g['lr'] for g in opt.param_groups] == [1e-3, 1e-4]
    assert opt.param_groups[1]['params'] == [model.merger.weight]
    assert opt.defaults['weight_decay'] == 0.0 and opt.defaults['betas'] == (0.9, 0.999)
    lrs = []
    for _ in range(301):
        lrs.append([g['lr'] for g in opt.param_groups])
        opt.step()
        sched.step()
    assert lrs[299] == [1e-3, 1e-4]                     # update 299: epoch 149
    assert lrs[300] == [5e-4, 5e-5]                     # update 300: epoch 150


def test_epix2vox_optimizer_matches_optax(rng):
    """152 Adam updates from the same gradients, one update per epoch, across
    the epoch-150 milestone: the port's param groups against optax's
    multi_transform (measured gap ~1e-7)."""
    enc, mer = rng.normal(size=(3, 2)).astype(np.float32), rng.normal(size=(2, 2))
    grads = rng.normal(size=(152, 5, 2)).astype(np.float32)
    tx = jopt.make_epix2vox_optimizer(updates_per_epoch=1)
    params = {'params': {'encoder': {'w': jnp.asarray(enc)},
                         'merger': {'w': jnp.asarray(mer, jnp.float32)}}}
    state = tx.init(params)

    @jax.jit
    def update(params, state, g):
        grads = {'params': {'encoder': {'w': g[:3]}, 'merger': {'w': g[3:]}}}
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    model = TinyModel(enc, mer)
    opt, sched = make_epix2vox_optimizer(model, updates_per_epoch=1)
    for g in grads:
        params, state = update(params, state, jnp.asarray(g))
        model.encoder.weight.grad, model.merger.weight.grad = T(g[:3]), T(g[3:])
        opt.step()
        sched.step()
    np.testing.assert_allclose(model.encoder.weight.detach().numpy(),
                               np.asarray(params['params']['encoder']['w']), atol=1e-5)
    np.testing.assert_allclose(model.merger.weight.detach().numpy(),
                               np.asarray(params['params']['merger']['w']), atol=1e-5)
