"""The kernel modules of the port (``acquisition_focus_tpu_torch/ops/kernels``).

On the CPU each wrapper takes its kernel's plain version; those are held against the
JAX package's Pallas kernels run in interpret mode, as the JAX package's own tests
run them (``tests/test_pallas*.py``). The tests marked ``cuda`` hold each CUDA
kernel against its plain version on the card and skip where there is none; on the
GPU machine they run without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

so this module imports JAX only inside the tests that compare with it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from acquisition_focus_tpu_torch.ops.kernels import _lib, affine_coefficients
from acquisition_focus_tpu_torch.models.hybrid_unet import Conv3x3x3
from acquisition_focus_tpu_torch.ops.kernels.conv3d import (
    conv3d, conv3d_fwd_cuda, conv3d_wgrad, conv3d_wgrad_cuda, supports_conv3d)
from acquisition_focus_tpu_torch.ops.kernels.plane_resample import (
    plane_resample, plane_resample_bwd, plane_resample_fwd)
from acquisition_focus_tpu_torch.ops.kernels.volume_resample import (
    affine_volume_resample, volume_resample_cuda)
from acquisition_focus_tpu_torch.ops.resample import (
    grid_sample, sample_slice_into_volume)


def T(a, **kw):
    return torch.tensor(np.asarray(a), dtype=torch.float32, **kw)


def rotation_affines(rng, n, offset=0.2, scale=1.0):
    """(n, 4, 4) random proper rotations (times ``scale``) with offsets."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out[i, :3, :3] = q * scale
        out[i, :3, 3] = rng.uniform(-offset, offset, 3)
    return out.astype(np.float32)


def close_scaled(got, ref, atol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got / scale, ref / scale, atol=atol)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (the fixture of
    tests/test_pallas.py, over all three kernel modules)."""
    import jax.experimental.pallas as pl
    from acquisition_focus_tpu.ops.pallas import conv3d as c3
    from acquisition_focus_tpu.ops.pallas import plane_resample as pr
    from acquisition_focus_tpu.ops.pallas import volume_resample as vr
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k['interpret'] = True
        return orig(*a, **k)

    for mod in (c3, pr, vr):
        monkeypatch.setattr(mod.pl, 'pallas_call', interp_call)
    return dict(conv3d=c3, plane=pr, volume=vr)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


# ---------------------------------------------------------------- K1 plane resample

def test_plane_resample_plain_matches_pallas_forward(interpret, rng):
    """S=16, C=3, theta as in tests/test_pallas.py."""
    S, C, B = 16, 3, 2
    slices = rng.normal(size=(B, C, S, S)).astype(np.float32)
    theta = rotation_affines(rng, B)
    ref = interpret['plane'].plane_resample_pallas(slices, theta, S)
    out = plane_resample(T(slices), T(theta), S)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_plane_resample_plain_matches_pallas_vjp(interpret, rng):
    import jax
    S, C, B = 16, 3, 2
    slices = rng.normal(size=(B, C, S, S)).astype(np.float32)
    theta = rotation_affines(rng, B)
    g = rng.normal(size=(B, C, S, S, S)).astype(np.float32)

    def loss(s, th):
        return (interpret['plane'].plane_resample_pallas(s, th, S) * g).sum()

    ds_j, dth_j = jax.grad(loss, argnums=(0, 1))(slices, theta)
    s, th = T(slices).requires_grad_(), T(theta).requires_grad_()
    (plane_resample(s, th, S) * T(g)).sum().backward()
    close_scaled(s.grad, ds_j, 1e-4)
    close_scaled(th.grad, dth_j, 1e-4)


def test_affine_coefficients_match_pallas(rng):
    """The kernels' (T, 3, 4) coefficient form of a grid affine, as both Pallas
    kernels build it."""
    from acquisition_focus_tpu.ops.pallas import plane_resample as pr
    from acquisition_focus_tpu.ops.pallas import volume_resample as vr
    theta = rotation_affines(rng, 3, scale=1.1)
    np.testing.assert_allclose(
        affine_coefficients(T(theta), (16,) * 3, (16,) * 3).numpy(),
        np.asarray(pr._coeffs_from_theta(theta, 16, 16)), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        affine_coefficients(T(theta), (8, 16, 24), (24, 32, 48)).numpy(),
        np.asarray(vr._coeffs_from_theta(theta, (8, 16, 24), (24, 32, 48))),
        rtol=1e-6, atol=1e-5)


def test_plane_resample_coefficients_reproduce_the_sample(rng):
    """Output voxel (d, h, w) maps to plane coordinates c0 + cd d + ch h + cw w:
    the kernel's form gives the plain version's sample points."""
    S = 8
    theta = T(rotation_affines(rng, 2))
    c = affine_coefficients(theta, (S,) * 3, (S,) * 3)
    from acquisition_focus_tpu_torch.ops.resample import _sample_points, _to_vox
    sx, sy, sz = _sample_points(theta[:, :3], (S,) * 3)
    d, h, w = torch.meshgrid(*(torch.arange(S, dtype=torch.float32),) * 3, indexing='ij')
    for r, s in enumerate((sx, sy, sz)):
        coord = c[:, r, 0, None, None, None] + c[:, r, 1, None, None, None] * d \
            + c[:, r, 2, None, None, None] * h + c[:, r, 3, None, None, None] * w
        np.testing.assert_allclose(coord.numpy(), _to_vox(s, S).numpy(), atol=1e-5)


# ---------------------------------------------------------------- K2 volume resample

DHW = (24, 32, 48)     # the shapes of tests/test_pallas_volume.py


@pytest.mark.parametrize('case', ['identity', 'rotation', 'shared_volume'])
def test_volume_resample_plain_matches_pallas(interpret, rng, case):
    B, C = (1, 3) if case == 'identity' else (2, 3)
    vol = rng.normal(size=(B, C) + DHW).astype(np.float32)
    if case == 'identity':
        theta = np.eye(4, dtype=np.float32)[None]
    elif case == 'rotation':
        theta = np.stack([rotation_affines(rng, 1, 0.15, s)[0] for s in (0.9, 1.2)])
    else:                   # 3 affines per volume: row t samples volume t % B
        theta = rotation_affines(rng, 3 * B, offset=0.1)
    ref = interpret['volume'].affine_volume_resample_pallas(vol, theta, DHW)
    out = affine_volume_resample(T(vol), T(theta), DHW)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_volume_resample_bf16_plain_matches_pallas(interpret, rng):
    import jax.numpy as jnp
    vol = rng.random((1, 6) + DHW).astype(np.float32)
    theta = rotation_affines(rng, 1, 0.15)
    ref = interpret['volume'].affine_volume_resample_pallas(
        jnp.asarray(vol, jnp.bfloat16), theta, DHW)
    out = affine_volume_resample(T(vol).to(torch.bfloat16), T(theta), DHW)
    assert out.dtype == torch.bfloat16
    # the Pallas kernel rounds its interpolation weights to bf16 (a ~1-2 output
    # ulp difference, tests/test_pallas_volume.py); the port keeps them f32
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2)


# ---------------------------------------------------------------- K3 conv3d

def test_conv3d_plain_matches_pallas(interpret, rng):
    """(B, D, H, W, Ci, Co) = (1, 8, 8, 128, 5, 7): interpret mode needs W % 128 == 0.
    The JAX kernel is channels-last DHWIO, the port NCDHW OIDHW."""
    B, D, H, W, Ci, Co = 1, 8, 8, 128, 5, 7
    x = rng.normal(size=(B, D, H, W, Ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, Ci, Co)) * 0.2).astype(np.float32)
    b = rng.normal(size=(Co,)).astype(np.float32)
    ref = np.asarray(interpret['conv3d'].conv3d_pallas(x, w)) + b
    out = conv3d(T(x.transpose(0, 4, 1, 2, 3)), T(w.transpose(4, 3, 0, 1, 2)), T(b))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 4, 1), ref, atol=1e-4)


@pytest.mark.parametrize('shape,ok', [
    ((2, 96, 128, 128, 128), True), ((2, 96, 64, 64, 64), False),
    ((1, 5, 8, 8, 128), True), ((1, 5, 8, 6, 128), False), ((1, 5, 4, 8, 128), False)])
def test_supports_conv3d_matches_pallas_guard(shape, ok):
    """The kernel engages exactly where the JAX package's Pallas conv does."""
    from acquisition_focus_tpu.ops.pallas.conv3d import supports_conv3d as jsupports
    B, Ci, D, H, W = shape
    assert supports_conv3d(shape, (48, Ci, 3, 3, 3)) is ok
    assert jsupports((B, D, H, W, Ci), (3, 3, 3, Ci, 48)) is ok


def test_hybrid_unet_routes_only_dec0_through_the_kernel():
    from acquisition_focus_tpu_torch.engine.runner import DEFAULTS, spec_from_config
    from acquisition_focus_tpu_torch.engine.train import make_models
    unet, _ = make_models(spec_from_config(DEFAULTS, 6, 3))
    S = 128
    routed = [s for s, stage in enumerate(unet.decoder)
              if stage.a_conv.mode
              and supports_conv3d((2, stage.a_conv.weight.shape[1]) + (S >> s,) * 3,
                                  stage.a_conv.weight.shape)]
    assert routed == [0]


# ---------------------------------------------------------------- K4 conv3d wgrad, modes

CONV_SHAPE = (1, 8, 8, 128, 5, 7)   # (B, D, H, W, Ci, Co): interpret mode needs W % 128


def conv_operands(rng):
    B, D, H, W, Ci, Co = CONV_SHAPE
    x = rng.normal(size=(B, D, H, W, Ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, Ci, Co)) * 0.2).astype(np.float32)
    g = rng.normal(size=(B, D, H, W, Co)).astype(np.float32)
    return x, w, g


def ncdhw(a):
    return T(a.transpose(0, 4, 1, 2, 3))


def test_conv3d_wgrad_plain_matches_pallas(interpret, rng):
    """K4's plain version against ``conv3d_wgrad_pallas`` in interpret mode: the
    JAX result is (3, 3, 3, Ci, Co), the port's (Co, Ci, 3, 3, 3), both float32."""
    x, _, g = conv_operands(rng)
    ref = np.asarray(interpret['conv3d'].conv3d_wgrad_pallas(x, g))
    out = conv3d_wgrad(ncdhw(x), ncdhw(g))
    assert out.dtype == torch.float32 and out.shape == (7, 5, 3, 3, 3)
    close_scaled(out.numpy().transpose(2, 3, 4, 1, 0), ref, 1e-5)


@pytest.mark.parametrize('mode', ['fwd', 'wg', 'dx', 'full'])
def test_conv_mode_gradients_match_pallas(interpret, rng, mode):
    """Each mode's (x, w) gradients against the JAX package's custom-vjp conv of
    that mode (``conv3d``/``conv3d_wg``/``conv3d_dx``/``conv3d_pg``) with its
    Pallas pieces in interpret mode; the port's CPU pieces are the kernels' plain
    versions (K3 as dx on the flipped, IO-swapped weights)."""
    import jax
    c3 = interpret['conv3d']
    fn = {'fwd': c3.conv3d, 'wg': c3.conv3d_wg, 'dx': c3.conv3d_dx, 'full': c3.conv3d_pg}[mode]
    x, w, g = conv_operands(rng)
    dx_j, dw_j = jax.grad(lambda a, b: (fn(a, b) * g).sum(), argnums=(0, 1))(x, w)
    xt, wt = ncdhw(x).requires_grad_(), T(w.transpose(4, 3, 0, 1, 2)).requires_grad_()
    out = conv3d(xt, wt, torch.zeros(7), kernel_dx=mode in ('dx', 'full'),
                 kernel_dw=mode in ('wg', 'full'))
    (out * ncdhw(g)).sum().backward()
    close_scaled(xt.grad.numpy().transpose(0, 2, 3, 4, 1), dx_j, 1e-5)
    close_scaled(wt.grad.numpy().transpose(2, 3, 4, 1, 0), dw_j, 1e-5)


@pytest.mark.parametrize('mode,ci,routed', [
    (False, 96, False), (True, 96, 'fwd'), ('fwd', 48, 'fwd'), ('fwd64', 96, 'fwd'),
    ('fwd64', 48, False), ('fwd48', 48, 'fwd'), ('wg', 48, 'wg'), ('dx', 96, 'dx'),
    ('full', 96, 'full')])
def test_conv3x3x3_modes_route_as_jax(mode, ci, routed):
    """The JAX package's mode table (``models/hybrid_unet.py:54-93``): 'fwdN' is
    'fwd' when the conv has at least N input channels, else off; K3 computes the
    input gradient under 'dx'/'full', K4 the weight gradient under 'wg'/'full'."""
    conv = Conv3x3x3(ci, 48, mode)
    assert conv.mode == routed or (routed == 'fwd' and conv.mode is True)


@pytest.mark.parametrize('mode', ['wgrad', 'ful', 'fwdx'])
def test_unknown_conv_mode_raises_as_jax(mode):
    import jax
    import jax.numpy as jnp
    from acquisition_focus_tpu.models.hybrid_unet import Conv3x3x3 as JConv
    with pytest.raises(ValueError):
        JConv(features=2, use_pallas=mode).init(jax.random.key(0), jnp.zeros((1, 2, 2, 2, 3)))
    with pytest.raises(ValueError):
        Conv3x3x3(3, 2, mode)


# ---------------------------------------------------------------- wrappers, no fallback

def test_cpu_wrappers_take_the_plain_versions_and_count_nothing(rng):
    _lib.reset_launch_counts()
    slices, theta = T(rng.normal(size=(1, 2, 8, 8))), T(rotation_affines(rng, 1))
    assert torch.equal(plane_resample(slices, theta, 8),
                       sample_slice_into_volume(slices, theta, 8))
    vol = T(rng.normal(size=(1, 2, 8, 8, 8)))
    assert torch.equal(affine_volume_resample(vol, theta, (8, 8, 8)),
                       grid_sample(vol, theta, (8, 8, 8)))
    x, w, b = T(rng.normal(size=(1, 2, 8, 4, 128))), T(rng.normal(size=(3, 2, 3, 3, 3))), \
        T(rng.normal(size=(3,)))
    assert torch.equal(conv3d(x, w, b), F.conv3d(x, w, b, padding=1))
    g = T(rng.normal(size=(1, 3, 8, 4, 128)))
    assert torch.equal(conv3d_wgrad(x, g),
                       torch.nn.grad.conv3d_weight(x, (3, 2, 3, 3, 3), g, padding=1))
    assert set(_lib.LAUNCHES.values()) == {0}


def test_kernel_launchers_refuse_cpu_tensors(rng):
    """The launch functions never fall back: a CPU tensor raises before any build."""
    slices, theta = T(rng.normal(size=(1, 2, 8, 8))), T(rotation_affines(rng, 1))
    coefs = affine_coefficients(theta, (8,) * 3, (8,) * 3)
    with pytest.raises(ValueError, match='CUDA'):
        plane_resample_fwd(slices, coefs, 8)
    with pytest.raises(ValueError, match='CUDA'):
        plane_resample_bwd(slices, coefs, torch.zeros(1, 2, 8, 8, 8))
    with pytest.raises(ValueError, match='CUDA'):
        volume_resample_cuda(T(rng.normal(size=(1, 2, 8, 8, 8))), theta, (8, 8, 8))
    with pytest.raises(ValueError, match='CUDA'):
        conv3d_fwd_cuda(torch.zeros(1, 2, 8, 4, 128), torch.zeros(3, 2, 3, 3, 3),
                        torch.zeros(3))
    with pytest.raises(ValueError, match='CUDA'):
        conv3d_wgrad_cuda(torch.zeros(1, 2, 8, 4, 128), torch.zeros(1, 3, 8, 4, 128))


# ---------------------------------------------------------------- CUDA kernels (card)

@pytest.mark.cuda
@pytest.mark.parametrize('S,C', [(16, 3), (32, 16), (8, 64)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plane_resample_kernel_matches_plain(cuda, S, C, dtype):
    rng = np.random.default_rng(0)
    slices = T(rng.normal(size=(2, C, S, S)), device=cuda).to(dtype)
    theta = T(rotation_affines(rng, 2), device=cuda)
    g = T(rng.normal(size=(2, C, S, S, S)), device=cuda).to(dtype)
    res = []
    for fn in (plane_resample, sample_slice_into_volume):
        s, th = slices.clone().requires_grad_(), theta.clone().requires_grad_()
        out = fn(s, th, S)
        res.append((out.detach(),) + torch.autograd.grad(out, (s, th), g))
    tol = (1e-2, 3e-2) if dtype == torch.bfloat16 else (1e-4, 1e-3)
    for i, (k, p) in enumerate(zip(*res)):
        assert k.dtype == p.dtype
        close_scaled(k.float().cpu(), p.float().cpu(), tol[min(i, 1)])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_volume_resample_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    vol = T(rng.random((2, 6) + DHW), device=cuda).to(dtype)
    theta = T(rotation_affines(rng, 6, 0.1), device=cuda)
    out = volume_resample_cuda(vol, theta, (16, 32, 40))
    ref = grid_sample(vol, theta, (16, 32, 40))
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ci,co', [(5, 7), (96, 48), (48, 48), (16, 70)])
def test_conv3d_kernel_matches_plain(cuda, dtype, ci, co):
    rng = np.random.default_rng(2)
    x = T(rng.normal(size=(2, ci, 8, 12, 128)), device=cuda).to(dtype)
    w = T(rng.normal(size=(co, ci, 3, 3, 3)) / np.sqrt(27 * ci), device=cuda)
    b = T(rng.normal(size=(co,)), device=cuda)
    out = conv3d_fwd_cuda(x, w, b)
    ref = F.conv3d(x, w.to(dtype), b.to(dtype), padding=1)
    close_scaled(out.float().cpu(), ref.float().cpu(),
                 1e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_conv3d_kernel_gradients_are_the_library_ones(cuda):
    rng = np.random.default_rng(3)
    x = T(rng.normal(size=(1, 8, 8, 4, 128)), device=cuda).requires_grad_()
    w = T(rng.normal(size=(6, 8, 3, 3, 3)) * 0.1, device=cuda).requires_grad_()
    b = T(rng.normal(size=(6,)), device=cuda).requires_grad_()
    g = T(rng.normal(size=(1, 6, 8, 4, 128)), device=cuda)
    got = torch.autograd.grad(conv3d(x, w, b), (x, w, b), g)
    ref = torch.autograd.grad(F.conv3d(x, w, b, padding=1), (x, w, b), g)
    for a, r in zip(got, ref):
        close_scaled(a.cpu(), r.cpu(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ci,co', [(5, 7), (96, 48), (48, 48), (16, 70)])
def test_conv3d_wgrad_kernel_matches_plain(cuda, dtype, ci, co):
    """K4 against the library's weight gradient in float32 on the same inputs:
    5e-4 (bf16) and 5e-5 (f32) of the reference's max (chip_smoke.py states the
    measurements behind them)."""
    rng = np.random.default_rng(5)
    x = T(rng.normal(size=(2, ci, 8, 12, 128)), device=cuda).to(dtype)
    g = T(rng.normal(size=(2, co, 8, 12, 128)), device=cuda).to(dtype)
    out = conv3d_wgrad_cuda(x, g)
    ref = torch.nn.grad.conv3d_weight(x.float(), (co, ci, 3, 3, 3), g.float(), padding=1)
    assert out.dtype == torch.float32
    close_scaled(out.cpu(), ref.cpu(), 5e-4 if dtype == torch.bfloat16 else 5e-5)
    assert torch.equal(out, conv3d_wgrad_cuda(x, g))     # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mode', ['wg', 'dx', 'full'])
def test_conv3d_mode_gradients_match_library(cuda, dtype, mode):
    """K3 as the input gradient and K4 as the weight gradient against the
    library's gradients of F.conv3d in float32 on the same inputs."""
    rng = np.random.default_rng(6)
    x = T(rng.normal(size=(1, 16, 8, 4, 128)), device=cuda).to(dtype).requires_grad_()
    w = T(rng.normal(size=(24, 16, 3, 3, 3)) * 0.1, device=cuda).requires_grad_()
    b = T(rng.normal(size=(24,)), device=cuda).requires_grad_()
    g = T(rng.normal(size=(1, 24, 8, 4, 128)), device=cuda).to(dtype)
    got = torch.autograd.grad(conv3d(x, w, b, mode in ('dx', 'full'), mode in ('wg', 'full')),
                              (x, w, b), g)
    x32 = x.detach().float().requires_grad_()
    w32 = w.detach().to(dtype).float().requires_grad_()
    b32 = b.detach().clone().requires_grad_()
    ref = torch.autograd.grad(F.conv3d(x32, w32, b32, padding=1), (x32, w32, b32), g.float())
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for a, r in zip(got, ref):
        close_scaled(a.float().cpu(), r.cpu(), tol)


@pytest.mark.cuda
def test_launch_counts(cuda):
    rng = np.random.default_rng(4)
    _lib.reset_launch_counts()
    s = T(rng.normal(size=(1, 4, 8, 8)), device=cuda).requires_grad_()
    th = T(rotation_affines(rng, 1), device=cuda)
    plane_resample(s, th, 8).sum().backward()
    affine_volume_resample(T(rng.normal(size=(1, 2, 8, 8, 8)), device=cuda), th,
                           (8, 8, 8))
    conv3d(torch.zeros(1, 2, 8, 4, 128, device=cuda), torch.zeros(3, 2, 3, 3, 3,
                                                                  device=cuda),
           torch.zeros(3, device=cuda))
    assert _lib.LAUNCHES == {'plane_resample_fwd': 1, 'plane_resample_bwd': 1,
                             'volume_resample': 1, 'conv3d_fwd': 1, 'conv3d_dx': 0,
                             'conv3d_wgrad': 0}
    x = torch.zeros(1, 2, 8, 4, 128, device=cuda, requires_grad=True)
    w = torch.zeros(3, 2, 3, 3, 3, device=cuda, requires_grad=True)
    conv3d(x, w, torch.zeros(3, device=cuda), True, True).sum().backward()
    assert (_lib.LAUNCHES['conv3d_fwd'], _lib.LAUNCHES['conv3d_dx'],
            _lib.LAUNCHES['conv3d_wgrad']) == (2, 1, 1)
