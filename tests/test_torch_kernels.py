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
from acquisition_focus_tpu_torch.models import recompute
from acquisition_focus_tpu_torch.models.atm import AffineTransformModule
from acquisition_focus_tpu_torch.models.hybrid_unet import Conv3x3x3, HybridUnet
from acquisition_focus_tpu_torch.ops.kernels.conv3d import (
    conv3d, conv3d_fwd_cuda, conv3d_wgrad, conv3d_wgrad_cuda, kernel_weights,
    supports_conv3d)
from acquisition_focus_tpu_torch.ops.kernels.plane_resample import (
    plane_resample, plane_resample_bwd, plane_resample_fwd, skip_concat)
from acquisition_focus_tpu_torch.ops.kernels.volume_resample import (
    affine_volume_resample, volume_resample_cuda)
from acquisition_focus_tpu_torch.ops.resample import (
    grid_sample, sample_slice_into_volume, sample_slice_into_volume_from_coefs)


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


@pytest.mark.parametrize('out_dhw,in_dhw', [((16,) * 3, (16,) * 3),
                                            ((15, 17, 19), (17, 19, 21)),
                                            ((128,) * 3, (96, 112, 80))])
def test_affine_coefficients_bit_equal_to_the_size_tensor_form(rng, out_dhw, in_dhw):
    """The sizes enter as Python scalars (no host-to-device copy per call); the
    coefficients are the same bits as with a float32 size tensor, also where the
    size ratios are not integers (n / do rounds once in float64, then to float32)."""
    theta = T(np.concatenate([rotation_affines(rng, 4, 0.3, 1.1),
                              rotation_affines(rng, 4, 0.1, 0.7)]))
    do, ho, wo = (float(s) for s in out_dhw)
    D, H, W = in_dhw
    a = theta[:, :3, :4]
    n = a.new_tensor([W, H, D])[None, :]
    s0 = (a[..., 0] * (1.0 / wo - 1.0) + a[..., 1] * (1.0 / ho - 1.0)
          + a[..., 2] * (1.0 / do - 1.0) + a[..., 3])
    c0 = ((s0 + 1.0) * n - 1.0) / 2.0
    ref = torch.stack([c0, a[..., 2] * (n / do), a[..., 1] * (n / ho),
                       a[..., 0] * (n / wo)], dim=-1)
    assert torch.equal(affine_coefficients(theta, out_dhw, in_dhw), ref)


@pytest.mark.parametrize('S,C,rounded', [(8, 3, False), (16, 4, False), (16, 4, True),
                                         (32, 2, False)])
def test_plane_coefficient_form_matches_plain(rng, S, C, rounded):
    """The plain version in the kernels' coordinate arithmetic against the plain
    version in normalized coordinates: forward, d_slices and d_theta, float32;
    closer on rounded affines, where both coordinate forms are exact and only the
    order of the sums differs."""
    theta = rotation_affines(rng, 2)
    theta = T(np.round(theta * 64) / 64 if rounded else theta)
    slices = T(rng.normal(size=(2, C, S, S)))
    g = T(rng.normal(size=(2, C, S, S, S)))
    res = []
    for fn in (sample_slice_into_volume, plane_from_coefs):
        s, th = slices.clone().requires_grad_(), theta.clone().requires_grad_()
        out = fn(s, th, S)
        res.append((out.detach(),) + torch.autograd.grad(out, (s, th), g))
    for k, p in zip(*res):
        close_scaled(k, p, 1e-6 if rounded else 1e-5)


def old_skip_concat(y, slices, theta):
    """The skip path before the concat buffer: ``sample_slice_into_volume`` per view,
    ``torch.cat`` of the views (the skip connector), ``torch.cat([y, skip])`` (the
    decoder stage)."""
    V, S = theta.shape[0], slices.shape[-1]
    F = slices.shape[1] // V
    skip = torch.cat([sample_slice_into_volume(slices[:, v * F:(v + 1) * F], theta[v], S)
                      for v in range(V)], dim=1)
    return skip if y is None else torch.cat([y, skip.to(y.dtype)], dim=1)


@pytest.mark.parametrize('S,F', [(8, 3), (16, 2)])
@pytest.mark.parametrize('V', [1, 3])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_skip_concat_plain_is_the_old_composition(rng, S, F, V, dtype):
    """On CPU tensors ``skip_concat`` is the former composition: the buffer and the
    gradients to y, the slices and theta bit-equal; with y None the skip alone."""
    slices = T(rng.normal(size=(2, V * F, S, S))).to(dtype)
    theta = T(rotation_affines(rng, V * 2).reshape(V, 2, 4, 4))
    y = T(rng.normal(size=(2, 5, S, S, S))).to(dtype)
    g = T(rng.normal(size=(2, 5 + V * F, S, S, S))).to(dtype)
    res = []
    for fn in (skip_concat, old_skip_concat):
        args = [a.clone().requires_grad_() for a in (y, slices, theta)]
        out = fn(*args)
        res.append((out.detach(),) + torch.autograd.grad(out, args, g))
    for a, b in zip(*res):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(skip_concat(None, slices, theta), old_skip_concat(None, slices, theta))


def test_skip_concat_refuses_mixed_dtypes(rng):
    """y and the slices must share a dtype: no quiet cast."""
    slices = T(rng.normal(size=(1, 3, 8, 8))).to(torch.bfloat16)
    theta = T(rotation_affines(rng, 3).reshape(3, 1, 4, 4))
    with pytest.raises(ValueError, match='dtype|float'):
        skip_concat(torch.zeros(1, 2, 8, 8, 8), slices, theta)


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
    unet, _ = make_models(spec_from_config(DEFAULTS, 6, 3), 'cpu')
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


@pytest.mark.parametrize('ci,co', [(5, 7), (96, 48), (48, 96)])
def test_kernel_weights_layout(rng, ci, co):
    """K3's weights as the kernels read them: bf16 (27, Co, Ci8), K-major with Ci
    zero-padded to a multiple of 8 (the TMA loads' 16-byte stride rule), and
    float32 (27, Ci, Co); tap = 9 kd + 3 kh + kw."""
    w = T(rng.normal(size=(co, ci, 3, 3, 3)))
    wt, ci_pad = kernel_weights(w, torch.bfloat16)
    assert wt.dtype == torch.bfloat16 and wt.is_contiguous()
    assert ci_pad % 8 == 0 and ci_pad - ci < 8 and wt.shape == (27, co, ci_pad)
    assert not wt[..., ci:].any()
    wf, n = kernel_weights(w, torch.float32)
    assert n == ci and wf.shape == (27, ci, co)
    for kd, kh, kw in ((0, 0, 0), (1, 2, 0), (2, 1, 2)):
        tap = 9 * kd + 3 * kh + kw
        assert torch.equal(wt[tap, :, :ci], w[:, :, kd, kh, kw].to(torch.bfloat16))
        assert torch.equal(wf[tap], w[:, :, kd, kh, kw].t())


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


def test_ctypes_signatures_match_the_sources():
    """Each C entry's ctypes argtypes (``_lib._SIGNATURES``) follow its declaration
    in ``csrc/*.cu``: a pointer as c_void_p, ``long long`` as c_longlong, ``int``
    as c_int."""
    import ctypes
    import re
    decls = {}
    for path in _lib.CSRC.glob('*.cu'):
        for name, params in re.findall(r'extern "C" [\w ]+?(afk_\w+)\(([^)]*)\)',
                                       path.read_text()):
            decls[name] = [ctypes.c_void_p if '*' in p else
                           ctypes.c_longlong if 'long long' in p else ctypes.c_int
                           for p in params.split(',')]
    for name, argtypes in _lib._SIGNATURES.items():
        assert decls[name] == argtypes, name


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
@pytest.mark.parametrize('S,C,rounded', [
    (16, 3, False), (32, 16, False), (8, 64, False), (4, 256, False),
    (16, 3, True), (32, 16, True), (8, 64, True), (4, 256, True), (128, 16, True)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plane_resample_kernel_matches_plain(cuda, S, C, rounded, dtype):
    """Random rotations, as they are or with entries ``rounded`` to multiples of
    2^-6, where the kernel's coefficient form and the plain version's normalized
    coordinates are both exact. At S = 128 on unrounded rotations the two forms'
    ~1e-5 voxel of rounding puts voxels on the other side of a kink of the
    gradient, and the float32 d_theta of the two plain forms differ by more than
    the tolerance (acquisition_focus_tpu_torch/PARITY.md): that case is held
    against the coefficient form below."""
    rng = np.random.default_rng(0)
    slices = T(rng.normal(size=(2, C, S, S)), device=cuda).to(dtype)
    theta = rotation_affines(rng, 2)
    theta = T(np.round(theta * 64) / 64 if rounded else theta, device=cuda)
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


def plane_from_coefs(slices, theta, S):
    """The plain version in the kernel's coordinate arithmetic, on theta."""
    coefs = affine_coefficients(theta, (S,) * 3, (S,) * 3)
    return sample_slice_into_volume_from_coefs(slices, coefs, S)


@pytest.mark.cuda
@pytest.mark.parametrize('S,C', [(16, 3), (32, 16), (8, 64), (4, 256), (128, 16)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plane_resample_kernel_matches_coefficient_form(cuda, S, C, dtype):
    """Unrounded random rotations against the plain version computing the
    kernel's own coordinates: on a plane of ones the float32 forward is bit-equal
    (the plane weight and bilinear weights, so the coordinates, are the same), and
    forward, d_slices and d_theta hold at the tolerances of the test above."""
    rng = np.random.default_rng(0)
    slices = T(rng.normal(size=(2, C, S, S)), device=cuda).to(dtype)
    theta = T(rotation_affines(rng, 2), device=cuda)
    g = T(rng.normal(size=(2, C, S, S, S)), device=cuda).to(dtype)
    ones = torch.ones((2, 1, S, S), device=cuda)
    assert torch.equal(plane_resample(ones, theta, S), plane_from_coefs(ones, theta, S))
    res = []
    for fn in (plane_resample, plane_from_coefs):
        s, th = slices.clone().requires_grad_(), theta.clone().requires_grad_()
        out = fn(s, th, S)
        res.append((out.detach(),) + torch.autograd.grad(out, (s, th), g))
    tol = (1e-2, 3e-2) if dtype == torch.bfloat16 else (1e-4, 1e-3)
    for i, (k, p) in enumerate(zip(*res)):
        assert k.dtype == p.dtype
        close_scaled(k.float().cpu(), p.float().cpu(), tol[min(i, 1)])


def plane_theta(axis, aligned):
    """(1, 4, 4) grid affine whose ix row moves fastest along output axis ``axis``
    ('d', 'h' or 'w'): a permutation of the axes, exactly aligned (the ix row has
    zeros on the other two axes) or turned by 0.3 rad about each axis."""
    perm = {'w': (0, 1, 2), 'h': (1, 0, 2), 'd': (2, 1, 0)}[axis]
    a = np.eye(4)
    a[:3, :3] = np.eye(3)[list(perm)]
    if not aligned:
        for i, j in ((0, 1), (1, 2), (0, 2)):
            r = np.eye(4)
            r[[i, i, j, j], [i, j, i, j]] = np.cos(0.3), -np.sin(0.3), np.sin(0.3), np.cos(0.3)
            a = a @ r
        a[:3, 3] = (0.05, -0.03, 0.02)
    return a[None].astype(np.float32)


def plane_grads(fn, slices, theta, g, S):
    s, th = slices.clone().requires_grad_(), theta.clone().requires_grad_()
    out = fn(s, th, S)
    return torch.autograd.grad(out, (s, th), g)


@pytest.mark.cuda
@pytest.mark.parametrize('aligned', [True, False])
@pytest.mark.parametrize('axis', ['d', 'h', 'w'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plane_resample_bwd_dominant_axes(cuda, dtype, axis, aligned):
    """K1b walks lines along the output axis where ix moves fastest: planes with
    each axis dominant, exactly axis-aligned (zero slope on the other two axes,
    sample points on voxel knots) or turned, against the plain autograd."""
    rng = np.random.default_rng(10)
    S, C = 16, 12
    theta = T(plane_theta(axis, aligned), device=cuda)
    slices = T(rng.normal(size=(1, C, S, S)), device=cuda).to(dtype)
    g = T(rng.normal(size=(1, C, S, S, S)), device=cuda).to(dtype)
    got = plane_grads(plane_resample, slices, theta, g, S)
    ref = plane_grads(sample_slice_into_volume, slices, theta, g, S)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-3
    for k, p in zip(got, ref):
        close_scaled(k.float().cpu(), p.float().cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plane_resample_bwd_plane_missing_the_volume(cuda, dtype):
    """A plane shifted off the volume along x: zero d_slices and d_coefs."""
    rng = np.random.default_rng(11)
    S, C = 16, 8
    theta = np.eye(4, dtype=np.float32)[None].copy()
    theta[0, 0, 3] = 3.0
    slices = T(rng.normal(size=(1, C, S, S)), device=cuda).to(dtype)
    coefs = affine_coefficients(T(theta, device=cuda), (S,) * 3, (S,) * 3).contiguous()
    g = T(rng.normal(size=(1, C, S, S, S)), device=cuda).to(dtype)
    d_slices, d_coefs = plane_resample_bwd(slices, coefs, g)
    assert not d_slices.any() and not d_coefs.any()
    ref = plane_grads(sample_slice_into_volume, slices, T(theta, device=cuda), g, S)
    assert not ref[0].any() and not ref[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plane_resample_bwd_same_bits_every_run(cuda, dtype):
    """No atomics in K1b: two runs on the same inputs give the same bits."""
    rng = np.random.default_rng(12)
    S, C = 32, 16
    slices = T(rng.normal(size=(2, C, S, S)), device=cuda).to(dtype)
    coefs = affine_coefficients(T(rotation_affines(rng, 2), device=cuda), (S,) * 3,
                                (S,) * 3).contiguous()
    g = T(rng.normal(size=(2, C, S, S, S)), device=cuda).to(dtype)
    first = plane_resample_bwd(slices, coefs, g)
    for _ in range(3):
        again = plane_resample_bwd(slices, coefs, g)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def kernel_plane_weight(coefs, S):
    """(T, S, S, S) plane weight max(0, 1 - |ix - S/2|) of the (T, 3, 4)
    coefficients, ix in the kernels' arithmetic (one float32 rounding per
    multiply-add, as ``sample_slice_into_volume_from_coefs``)."""
    r = torch.arange(S, dtype=torch.float64, device=coefs.device)
    c = coefs[:, 0, :, None, None, None].double()
    ix = c[:, 0].float()
    for j, v in enumerate((r[:, None, None], r[None, :, None], r[None, None, :]), 1):
        ix = (c[:, j] * v + ix.double()).float()
    return torch.clamp(1.0 - (ix - S // 2).abs(), min=0.0)


def view_inputs(device, S, F, V, dtype, seed, rounded=False):
    """(2, V*F, S, S) planes, (V, 2, 4, 4) rotations and their (V, 2, 3, 4)
    coefficients."""
    rng = np.random.default_rng(seed)
    slices = T(rng.normal(size=(2, V * F, S, S)), device=device).to(dtype)
    theta = rotation_affines(rng, V * 2)
    theta = T(np.round(theta * 64) / 64 if rounded else theta, device=device)
    coefs = affine_coefficients(theta, (S,) * 3, (S,) * 3).reshape(V, 2, 3, 4).contiguous()
    return slices, theta.reshape(V, 2, 4, 4), coefs


@pytest.mark.cuda
@pytest.mark.parametrize('S,F', [(4, 8), (8, 8), (16, 6), (32, 4), (64, 2), (128, 2), (5, 3)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plane_resample_fwd_into_nan_buffer(cuda, dtype, S, F):
    """Three views into channels 7.. of a NaN-filled (2, 7 + 3F + 2, S^3) buffer
    (S 5: 125 voxels a channel, the unaligned path): no NaN is left in them, the
    other channels keep their NaNs, every voxel of zero plane weight is exactly 0,
    and the views hold the plain version in the kernel's coordinates within 1e-5
    (float32) or 1e-2 (bfloat16) of its max; on planes of ones float32 is
    bit-equal to it."""
    V, c_off = 3, 7
    slices, theta, coefs = view_inputs(cuda, S, F, V, dtype, seed=20)
    buf = torch.full((2, c_off + V * F + 2) + (S,) * 3, float('nan'), dtype=dtype,
                     device=cuda)
    plane_resample_fwd(slices, coefs, S, buf, c_off)
    got = buf[:, c_off:c_off + V * F]
    assert not got.isnan().any()
    assert buf[:, :c_off].isnan().all() and buf[:, c_off + V * F:].isnan().all()
    pw = kernel_plane_weight(coefs.reshape(-1, 3, 4), S).reshape(V, 2, 1, S, S, S)
    for v in range(V):
        view = got[:, v * F:(v + 1) * F]
        assert (view[(pw[v] == 0).expand_as(view)] == 0).all()
        ref = sample_slice_into_volume_from_coefs(slices[:, v * F:(v + 1) * F], coefs[v], S)
        close_scaled(view.float().cpu(), ref.float().cpu(),
                     1e-5 if dtype == torch.float32 else 1e-2)
    if dtype == torch.float32:
        ones = torch.ones((2, V, S, S), device=cuda)
        got = plane_resample_fwd(ones, coefs, S)
        for v in range(V):
            assert torch.equal(got[:, v:v + 1],
                               sample_slice_into_volume_from_coefs(ones[:, v:v + 1], coefs[v], S))


@pytest.mark.cuda
@pytest.mark.parametrize('S,F', [(16, 8), (8, 64), (32, 3)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plane_resample_three_views_bit_equal_to_one_view(cuda, dtype, S, F):
    """One three-view launch of K1f (into a buffer at channel 5) and of K1b
    (reading that buffer's cotangent in place) gives the bits of three one-view
    launches; K1b in place gives the bits of K1b on a contiguous copy of the
    views' channels, and the same bits on a second run."""
    V, c_off = 3, 5
    slices, _, coefs = view_inputs(cuda, S, F, V, dtype, seed=21)
    buf = torch.empty((2, c_off + V * F) + (S,) * 3, dtype=dtype, device=cuda)
    plane_resample_fwd(slices, coefs, S, buf, c_off)
    g = torch.randn(buf.shape, device=cuda).to(dtype)
    d_slices, d_coefs = plane_resample_bwd(slices, coefs, g, c_off)
    for v in range(V):
        sv = slices[:, v * F:(v + 1) * F].contiguous()
        assert torch.equal(buf[:, c_off + v * F:c_off + (v + 1) * F],
                           plane_resample_fwd(sv, coefs[v], S))
        ds, dc = plane_resample_bwd(
            sv, coefs[v], g[:, c_off + v * F:c_off + (v + 1) * F].contiguous())
        assert torch.equal(d_slices[:, v * F:(v + 1) * F], ds) and torch.equal(d_coefs[v], dc)
    copy = plane_resample_bwd(slices, coefs, g[:, c_off:].contiguous())
    again = plane_resample_bwd(slices, coefs, g, c_off)
    for a, b, c in zip((d_slices, d_coefs), copy, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize('S,F,with_y', [(16, 3, True), (8, 16, True), (32, 4, False)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_skip_concat_kernel_matches_plain(cuda, dtype, S, F, with_y):
    """``skip_concat`` on the card (one buffer, one K1f and one K1b launch) against
    the former composition on the same CUDA tensors, on rotations rounded to
    multiples of 2^-6 (both coordinate forms exact): the buffer and the gradients
    to y (bit-equal), the slices and theta, at the tolerances of
    test_plane_resample_kernel_matches_plain."""
    check_skip_concat_kernel(cuda, dtype, S, F, with_y, 3)


@pytest.mark.cuda
@pytest.mark.parametrize('S,F,with_y', [(16, 3, True), (8, 16, True), (32, 4, False),
                                        (128, 2, True)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_skip_concat_kernel_matches_plain_two_views(cuda, dtype, S, F, with_y):
    """As test_skip_concat_kernel_matches_plain with two views (the from-segmented
    configs' axial + coronal)."""
    check_skip_concat_kernel(cuda, dtype, S, F, with_y, 2)


def check_skip_concat_kernel(cuda, dtype, S, F, with_y, V):
    slices, theta, _ = view_inputs(cuda, S, F, V, dtype, seed=22, rounded=True)
    y = torch.randn((2, 5) + (S,) * 3, device=cuda).to(dtype) if with_y else None
    g = torch.randn((2, (5 if with_y else 0) + V * F) + (S,) * 3, device=cuda).to(dtype)
    res = []
    for fn in (skip_concat, old_skip_concat):
        args = [a.clone().requires_grad_() for a in (y, slices, theta) if a is not None]
        out = fn(*([None] if y is None else []), *args)
        res.append((out.detach(),) + torch.autograd.grad(out, args, g))
    tol = (1e-2, 3e-2) if dtype == torch.bfloat16 else (1e-4, 1e-3)
    if with_y:
        assert torch.equal(res[0][0][:, :5], y) and torch.equal(res[0][1], g[:, :5])
    for i, (k, p) in enumerate(zip(*res)):
        assert k.dtype == p.dtype
        close_scaled(k.float().cpu(), p.float().cpu(), tol[min(i, 1)])


K2_ZOOMS = (0.7, 0.85, 1.0, 1.15, 1.3, 1.45)


@pytest.mark.cuda
@pytest.mark.parametrize('B,C,n_theta,zooms,in_dhw,out_dhw', [
    (2, 6, 6, (1.0,), DHW, (16, 32, 40)),
    # channel counts around K2's groups of 8 (1, 6 and 8 in one group, 11 in two),
    # each volume shared by 3 affines (T = 3 B), zooms 0.7-1.45
    (2, 1, 6, K2_ZOOMS, DHW, (16, 32, 40)),
    (2, 6, 6, K2_ZOOMS, DHW, (16, 32, 40)),
    (2, 8, 6, K2_ZOOMS, DHW, (16, 32, 40)),
    (2, 11, 6, K2_ZOOMS, DHW, (16, 32, 40)),
    # odd output width (single stores at each row's end) and odd extents
    (1, 3, 2, (1.1,), (17, 19, 21), (15, 17, 19)),
    # a shrink by 4 per axis over the same field of view (the from-segmented
    # configs' 32^3 prescan from the 128^3 volume)
    (2, 6, 4, (1.0,), (64, 64, 64), (16, 16, 16)),
    # one volume and its three views' affines: a rank's share of a batch of 2 on a
    # 'data' axis of 2 (parallel/)
    (1, 6, 3, K2_ZOOMS, DHW, (16, 32, 40))])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_volume_resample_kernel_matches_plain(cuda, dtype, B, C, n_theta, zooms, in_dhw,
                                              out_dhw):
    """Affine t is a random rotation times zooms[t % len(zooms)] and samples
    volume t % B."""
    rng = np.random.default_rng(1)
    vol = T(rng.random((B, C) + in_dhw), device=cuda).to(dtype)
    offset = 0.1 if n_theta > 2 else 0.2
    theta = T(np.concatenate([rotation_affines(rng, 1, offset, zooms[t % len(zooms)])
                              for t in range(n_theta)]), device=cuda)
    out = volume_resample_cuda(vol, theta, out_dhw)
    ref = grid_sample(vol, theta, out_dhw)
    assert out.shape == (n_theta, C) + out_dhw and out.dtype == dtype
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ci,co', [(5, 7), (96, 48), (48, 48), (16, 70), (48, 96), (64, 32),
                                   (32, 32), (32, 64)])
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
@pytest.mark.parametrize('ci,co', [(5, 7), (96, 48), (48, 48), (16, 70), (64, 32), (32, 32)])
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
    check_conv3d_mode_gradients(cuda, dtype, mode, 1, 16, 24)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ci,co', [(64, 32), (32, 32)])
def test_conv3d_full_gradients_at_the_two_view_channels(cuda, dtype, ci, co):
    """As test_conv3d_mode_gradients_match_library under 'full', at batch 2 and the
    full-resolution decoder convs of a two-view hybrid U-Net (the from-segmented
    configs): 64 -> 32 and 32 -> 32."""
    check_conv3d_mode_gradients(cuda, dtype, 'full', 2, ci, co)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ci,co', [(96, 24), (48, 24), (96, 12), (48, 12)])
def test_conv3d_full_gradients_at_the_mesh_shard_channels(cuda, dtype, ci, co):
    """As test_conv3d_mode_gradients_match_library under 'full' (K3 forward, K3
    as dx, K4), at batch 1 and the channels a 'model' axis of 2 and 4 leaves the
    reference-width 128^3 decoder convs (96 / 48 -> 48 / m; parallel/)."""
    check_conv3d_mode_gradients(cuda, dtype, 'full', 1, ci, co)


def check_conv3d_mode_gradients(cuda, dtype, mode, B, ci, co):
    rng = np.random.default_rng(6)
    x = T(rng.normal(size=(B, ci, 8, 4, 128)), device=cuda).to(dtype).requires_grad_()
    w = T(rng.normal(size=(co, ci, 3, 3, 3)) * 0.1, device=cuda).requires_grad_()
    b = T(rng.normal(size=(co,)), device=cuda).requires_grad_()
    g = T(rng.normal(size=(B, co, 8, 4, 128)), device=cuda).to(dtype)
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
@pytest.mark.parametrize('ci,co', [(96, 48), (48, 96)])
def test_conv3d_kernels_batch_one(cuda, ci, co):
    """K3 and K4 in bf16 at batch 1 (the evaluation batch)."""
    rng = np.random.default_rng(7)
    x = T(rng.normal(size=(1, ci, 8, 12, 128)), device=cuda).to(torch.bfloat16)
    w = T(rng.normal(size=(co, ci, 3, 3, 3)) / np.sqrt(27 * ci), device=cuda)
    b = T(rng.normal(size=(co,)), device=cuda)
    g = T(rng.normal(size=(1, co, 8, 12, 128)), device=cuda).to(torch.bfloat16)
    close_scaled(conv3d_fwd_cuda(x, w, b).float().cpu(),
                 F.conv3d(x.float(), w.to(torch.bfloat16).float(), b, padding=1).cpu(), 1e-2)
    close_scaled(conv3d_wgrad_cuda(x, g).cpu(),
                 torch.nn.grad.conv3d_weight(x.float(), (co, ci, 3, 3, 3), g.float(),
                                             padding=1).cpu(), 5e-4)


@pytest.mark.cuda
def test_conv3d_kernels_zero_fill_on_faces(cuda):
    """Input nonzero only on the volume's faces (d, h, w = 0 and 127): a tap that
    reads past a face must see SAME padding (zeros), not the neighbouring row or
    channel, in K3 (forward) and K4 (weight gradient), bf16."""
    rng = np.random.default_rng(8)
    S, ci, co = 128, 16, 24
    face = np.zeros((S, S, S), bool)
    for ax in range(3):
        idx = [slice(None)] * 3
        for edge in (0, S - 1):
            idx[ax] = edge
            face[tuple(idx)] = True
    x = T(rng.normal(size=(1, ci, S, S, S)) * face, device=cuda).to(torch.bfloat16)
    w = T(rng.normal(size=(co, ci, 3, 3, 3)) / np.sqrt(27 * ci), device=cuda)
    b = torch.zeros(co, device=cuda)
    g = T(rng.normal(size=(1, co, S, S, S)), device=cuda).to(torch.bfloat16)
    close_scaled(conv3d_fwd_cuda(x, w, b).float().cpu(),
                 F.conv3d(x.float(), w.to(torch.bfloat16).float(), b, padding=1).cpu(), 1e-2)
    close_scaled(conv3d_wgrad_cuda(x, g).cpu(),
                 torch.nn.grad.conv3d_weight(x.float(), (co, ci, 3, 3, 3), g.float(),
                                             padding=1).cpu(), 5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_conv3d_full_mode_gradients_two_w_tiles(cuda, dtype):
    """'full' mode (K3 forward and as the input gradient, K4) where a row spans two
    128-voxel w tiles (W 256) and the input gradient has more channels than the
    cotangent, against the library's float32 gradients."""
    rng = np.random.default_rng(9)
    x = T(rng.normal(size=(1, 24, 8, 4, 256)), device=cuda).to(dtype).requires_grad_()
    w = T(rng.normal(size=(16, 24, 3, 3, 3)) * 0.1, device=cuda).requires_grad_()
    b = T(rng.normal(size=(16,)), device=cuda).requires_grad_()
    g = T(rng.normal(size=(1, 16, 8, 4, 256)), device=cuda).to(dtype)
    got = torch.autograd.grad(conv3d(x, w, b, True, True), (x, w, b), g)
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
    # the skip connector's three views: one launch each way
    s3 = T(rng.normal(size=(1, 6, 8, 8)), device=cuda).requires_grad_()
    y = torch.zeros(1, 2, 8, 8, 8, device=cuda, requires_grad=True)
    skip_concat(y, s3, T(rotation_affines(rng, 3).reshape(3, 1, 4, 4), device=cuda)
                ).sum().backward()
    assert (_lib.LAUNCHES['plane_resample_fwd'], _lib.LAUNCHES['plane_resample_bwd']) == (2, 2)
    x = torch.zeros(1, 2, 8, 4, 128, device=cuda, requires_grad=True)
    w = torch.zeros(3, 2, 3, 3, 3, device=cuda, requires_grad=True)
    conv3d(x, w, torch.zeros(3, device=cuda), True, True).sum().backward()
    assert (_lib.LAUNCHES['conv3d_fwd'], _lib.LAUNCHES['conv3d_dx'],
            _lib.LAUNCHES['conv3d_wgrad']) == (2, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('unet_remat', [False, True])
def test_kernel_launches_under_recompute(cuda, unet_remat):
    """A narrow U-Net at 128^3 in bf16 on the card, forward and backward: under
    the default recompute policy K1f launches once per level and K3 once per
    full-resolution conv, as with no recompute (the policy keeps their outputs);
    under unet_remat the stages and the deepest re-embedding run again, so both
    launch twice. K1b launches once per level either way."""
    torch.manual_seed(0)
    n_levels = 3
    unet = HybridUnet(3, 2, base_features=(4, 8, 8), dtype=torch.bfloat16,
                      use_pallas_conv='fwd', remat_skips=unet_remat,
                      decoder_save_names=('conv_out', 'conv_in0')).to(cuda)
    x = torch.rand(1, 6, 128, 128, device=cuda)
    aff = torch.eye(4, device=cuda).expand(3, 1, 4, 4).contiguous()
    _lib.reset_launch_counts()
    unet(x, aff).float().square().mean().backward()
    torch.cuda.synchronize()
    times = 2 if unet_remat else 1
    assert _lib.LAUNCHES['plane_resample_fwd'] == times * n_levels
    assert _lib.LAUNCHES['plane_resample_bwd'] == n_levels
    assert _lib.LAUNCHES['conv3d_fwd'] == times * 2


@pytest.mark.cuda
def test_regions_wait_for_the_device_nowhere(cuda):
    """The default recompute regions on the card, forward and backward (a narrow
    U-Net at 128^3 in bf16 whose affines need gradients, and an ATM view chain),
    with the sync debug mode set to raise: no op of their forwards or replays
    waits for the device, which would idle the card while the host replays the
    next region. The first step (kernel builds, the first replays' op counts)
    runs before."""
    torch.manual_seed(0)
    unet = HybridUnet(3, 2, base_features=(4, 8, 8), dtype=torch.bfloat16,
                      use_pallas_conv='fwd', remat_skips=False,
                      decoder_save_names=('conv_out', 'conv_in0')).to(cuda)
    atm = AffineTransformModule(2, prescan_spat=32, locnet_width=2,
                                dtype=torch.bfloat16).to(cuda)
    x = torch.rand(1, 6, 128, 128, device=cuda)
    prescan = torch.rand(1, 2, 32, 32, 32, device=cuda)
    aff = torch.eye(4, device=cuda).expand(3, 1, 4, 4).contiguous().requires_grad_()

    def step():
        theta = recompute.region(atm, prescan, save_ops=recompute.CONV_OUT)
        loss = unet(x, aff).float().square().mean() + theta.square().sum()
        loss.backward()

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert aff.grad is not None and torch.isfinite(aff.grad).all()
