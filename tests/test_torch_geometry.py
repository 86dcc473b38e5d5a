"""The port's geometry for the dataset build against the JAX package's, on the CPU:
``jax.random``'s draws in numpy (``utils/jax_prng.py``), label moments and their
principal axes, the clinical view affines, the centroid fit, and the crop around
the label center.

Tolerances, each with the largest gap measured on these inputs beside it:
moments rtol 1e-5 (5.1e-6: float32 sums over 64^3 voxels in another order); view
affines 1e-4 (2.9e-6); centroid fit after 20 steps 1e-5 (6.4e-6); cropped images
1e-5 (7.7e-7); normal draws 3 float32 ulps (3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acquisition_focus_tpu.data.synthetic import make_heart_phantom
from acquisition_focus_tpu.geometry import centroids as jcent
from acquisition_focus_tpu.geometry import moments as jmom
from acquisition_focus_tpu.geometry.clinical_views import (
    get_clinical_cardiac_view_affines as jviews)
from acquisition_focus_tpu.ops.resample import crop_around_label_center as jcrop
from acquisition_focus_tpu.ops.rotations import random_affine as jrandom_affine
from acquisition_focus_tpu_torch.geometry import centroids as tcent
from acquisition_focus_tpu_torch.geometry import moments as tmom
from acquisition_focus_tpu_torch.geometry.clinical_views import (
    get_clinical_cardiac_view_affines as tviews)
from acquisition_focus_tpu_torch.ops.resample import crop_around_label_center as tcrop
from acquisition_focus_tpu_torch.ops.rotations import random_affine_from_jax_key
from acquisition_focus_tpu_torch.utils import jax_prng

CLASS_DICT = {"background": 0, "MYO": 1, "LV": 2, "RV": 3, "LA": 4, "RA": 5}
SEEDS = [0, 1, 42, 1000, 1001, 1002, 1003]


@pytest.fixture(scope='module')
def phantom64():
    return make_heart_phantom(shape=(64,) * 3, seed=1)


# ---------------------------------------------------------------- jax_prng

@pytest.mark.parametrize('seed', SEEDS)
def test_prng_key_split_uniform_bit_equal(seed):
    kj, kp = jax.random.key(seed), jax_prng.key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(kj)), kp)
    for num in (2, 3, 4):
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jax.random.split(kj, num))),
            jax_prng.split(kp, num))
    for shape in ((), (2,), (6,), (3, 5), (2000,)):
        np.testing.assert_array_equal(np.asarray(jax.random.uniform(kj, shape)),
                                      jax_prng.uniform(kp, shape))
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kj, (7,), minval=-2.0, maxval=3.0)),
        jax_prng.uniform(kp, (7,), -2.0, 3.0))


@pytest.mark.parametrize('seed', SEEDS)
def test_prng_normal_within_three_ulps(seed):
    """XLA's erfinv is ported term for term, its CPU log1p is not: about one draw
    in a hundred is off by up to 3 ulps; the short draws the build makes match."""
    kj, kp = jax.random.key(seed), jax_prng.key(seed)
    nj = np.asarray(jax.random.normal(kj, (20000,)))
    npp = jax_prng.normal(kp, (20000,))
    ulps = np.abs(nj - npp) / np.spacing(np.abs(nj))
    assert ulps.max() <= 3
    assert (ulps > 0).mean() < 0.02
    for k in jax_prng.split(kp, 4):
        kj2 = jax.random.wrap_key_data(k)
        for shape in ((1,), (2,), (3,), (6,)):
            np.testing.assert_allclose(jax_prng.normal(k, shape),
                                       np.asarray(jax.random.normal(kj2, shape)),
                                       rtol=3e-7, atol=0)


@pytest.mark.parametrize('v_idx', [0, 1, 2])
def test_rnd_view_affine_matches_jax(v_idx):
    """The 'RND' base view: ``random_affine(key(seed + 1000 + v), 4.0, 0.0)``."""
    key = 1000 + v_idx
    want = np.asarray(jrandom_affine(jax.random.key(key), rotation_strength=4.0,
                                     zoom_strength=0.0))
    got = random_affine_from_jax_key(jax_prng.key(key), rotation_strength=4.0,
                                     zoom_strength=0.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------- moments

@pytest.mark.parametrize('classes', [(1, 2), (2,), (1,), (1, 2, 3, 4, 5)])
def test_moments_match_jax(phantom64, classes):
    mask = np.isin(phantom64[0], classes)
    cj, ij = jmom.label_inertia_tensor(jnp.asarray(mask))
    ct, it = tmom.label_inertia_tensor(torch.as_tensor(mask))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ij)).max())
    np.testing.assert_allclose(tmom.label_center(torch.as_tensor(mask)).numpy(),
                               np.asarray(jmom.label_center(jnp.asarray(mask))), rtol=1e-5)
    cj, mj = jmom.label_center_and_median(jnp.asarray(mask))
    ct, mt = tmom.label_center_and_median(torch.as_tensor(mask))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_center_and_median_of_an_empty_mask():
    cj, mj = jmom.label_center_and_median(jnp.zeros((4, 6, 8)))
    ct, mt = tmom.label_center_and_median(torch.zeros(4, 6, 8))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_principal_axes_signs_match_jax():
    """Eigenvectors, signs included, on 300 seeded symmetric float32 matrices:
    LAPACK's syevd on the host, as jaxlib's CPU eigh. ``torch.linalg.eigh`` flips
    some of them (the guard below: if it stopped doing so, the host route would
    no longer be needed)."""
    rng = np.random.default_rng(0)
    torch_flips = 0
    for _ in range(300):
        a = rng.normal(size=(3, 3)).astype(np.float32)
        a = a + a.T
        want = np.stack([np.asarray(v) for v in jmom.principal_axes(jnp.asarray(a))])
        got = np.stack(tmom.principal_axes(torch.as_tensor(a)))
        np.testing.assert_array_equal(got, want)
        torch_vecs = torch.linalg.eigh(torch.as_tensor(a))[1].T.numpy()
        torch_flips += not np.allclose(torch_vecs, want, atol=1e-4)
    assert torch_flips > 0


# ---------------------------------------------------------------- clinical views

@pytest.mark.parametrize('shape,seed', [((64,) * 3, 1), ((64,) * 3, 3), ((128,) * 3, 0)],
                         ids=['64-seed1', '64-seed3', '128-seed0'])
@pytest.mark.parametrize('num_sa', [3, 15])
def test_clinical_views_match_jax(shape, seed, num_sa):
    """Phantoms at 1.5 mm (128^3: the default 192 mm hires grid)."""
    label, _, affine = make_heart_phantom(shape=shape, seed=seed)
    want = jviews(label, affine, CLASS_DICT, num_sa_slices=num_sa, return_unrolled=True)
    got = tviews(torch.as_tensor(label), affine, CLASS_DICT, num_sa_slices=num_sa,
                 return_unrolled=True)
    assert set(got) == set(want) and len(got) == 7 + num_sa
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)


def test_clinical_views_of_missing_structures_are_empty():
    label = np.zeros((16, 16, 16), np.int32)
    label[4:8, 4:8, 4:8] = 5            # RA only: no MYO, LV, RV, LA
    assert tviews(torch.as_tensor(label), np.eye(4), CLASS_DICT) == {}
    assert jviews(label, np.eye(4), CLASS_DICT) == {}
    assert tviews(np.zeros((16, 16, 16), np.int32), np.eye(4), CLASS_DICT) == {}


# ---------------------------------------------------------------- centroid fit

@pytest.fixture(scope='module')
def centroid_inputs():
    ref, _, _ = make_heart_phantom((64,) * 3, seed=42, tilt=0.0)
    moving, _, _ = make_heart_phantom((64,) * 3, seed=3)
    classes = [1, 2, 3, 4, 5]
    return ref, moving, classes


def _jax_fit(params, iters, fixed, moving):
    """The JAX package's fitting loop (``register_centroids``, dof 6) from given
    initial parameters."""
    import optax
    from acquisition_focus_tpu.ops.affine import compose
    from acquisition_focus_tpu.ops.rotations import rotation_from_r6
    fixed = jnp.asarray(fixed, jnp.float32)
    moving = jnp.asarray(moving, jnp.float32)

    def transform(p):
        mat = compose(jnp.eye(4) * 1.0, rotation_from_r6(p['rot'][None])[0])
        return mat.at[:3, 3].add(p['trans'])

    def loss(p):
        return jnp.mean(((transform(p) @ moving.T).T - fixed) ** 2)

    opt = optax.adamw(0.05, b1=0.9, b2=0.999, weight_decay=0.01)

    @jax.jit
    def fit(p):
        def body(_, carry):
            p, st = carry
            upd, st = opt.update(jax.grad(loss)(p), st, p)
            return optax.apply_updates(p, upd), st
        return transform(jax.lax.fori_loop(0, iters, body, (p, opt.init(p)))[0])

    return np.asarray(fit({k: jnp.asarray(v) for k, v in params.items()}))


def test_centroid_centers_and_initial_draws_match_jax(centroid_inputs):
    ref, moving, classes = centroid_inputs
    for lbl in (ref, moving):
        np.testing.assert_allclose(
            tcent._class_centers_grid_space(torch.as_tensor(lbl), classes),
            jcent._class_centers_grid_space(lbl, classes), rtol=1e-6, atol=1e-7)
    k_zoom, k_rot, k_trans = jax.random.split(jax.random.key(0), 3)
    init = tcent.initial_params(0, dof=7)
    np.testing.assert_array_equal(init['rot'], np.asarray(jax.random.normal(k_rot, (6,))))
    np.testing.assert_array_equal(init['trans'],
                                  np.asarray(jax.random.normal(k_trans, (3,))))
    np.testing.assert_array_equal(init['zoom'], np.asarray(jax.random.normal(k_zoom, (1,))))


@pytest.mark.parametrize('iters', [1, 5, 20])
def test_centroid_fit_short_horizon_matches_jax(centroid_inputs, iters):
    """From JAX's initial parameters, the fitted matrix after ``iters`` AdamW steps
    within 1e-5 of the JAX loop's (6.4e-6 measured at 20)."""
    ref, moving, classes = centroid_inputs
    fixed = jcent._class_centers_grid_space(ref, classes).astype(np.float32)
    mov = jcent._class_centers_grid_space(moving, classes).astype(np.float32)
    k_zoom, k_rot, k_trans = jax.random.split(jax.random.key(0), 3)
    params = {'rot': np.asarray(jax.random.normal(k_rot, (6,))),
              'trans': np.asarray(jax.random.normal(k_trans, (3,)))}
    got = tcent.fit_centroid_affine(fixed, mov, params, iters).numpy()
    np.testing.assert_allclose(got, _jax_fit(params, iters, fixed, mov), atol=1e-5)


def test_register_centroids_full_fit_is_rigid_and_deterministic(centroid_inputs):
    """At 500 steps the fit has not converged and its result follows the float
    rounding of each step, so it is not compared with JAX's (``PARITY.md``): it
    is a rigid transform and the same bits on every call."""
    ref, moving, classes = centroid_inputs
    a = tcent.register_centroids(ref, moving)
    b = tcent.register_centroids(torch.as_tensor(ref), torch.as_tensor(moving))
    assert a.shape == (4, 4) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    lin = a[:3, :3].astype(np.float64)
    np.testing.assert_allclose(np.linalg.det(lin), 1.0, atol=1e-5)
    np.testing.assert_allclose(lin @ lin.T, np.eye(3), atol=1e-5)
    np.testing.assert_array_equal(a[3], [0, 0, 0, 1])


def test_centroid_fit_at_500_steps_is_as_far_from_jax_as_jax_from_itself(capsys):
    """The reference's own sensitivity, which is why the 500-step matrices are not
    compared: from JAX's initial draws scaled by (1 + 2^-23), the JAX fit lands
    1e-2 to 1e-1 away from its unscaled result on four phantom cases, and the
    port's fit from the unscaled draws is as far (within 10x) from JAX's. The
    numbers print with ``-s`` (``PARITY.md``)."""
    ref, _, _ = make_heart_phantom((64,) * 3, seed=42, tilt=0.0)
    k_zoom, k_rot, k_trans = jax.random.split(jax.random.key(0), 3)
    params = {'rot': np.asarray(jax.random.normal(k_rot, (6,))),
              'trans': np.asarray(jax.random.normal(k_trans, (3,)))}
    scaled = {k: (v * np.float32(1 + 2 ** -23)).astype(np.float32)
              for k, v in params.items()}
    for seed in range(4):
        moving, _, _ = make_heart_phantom((64,) * 3, seed=seed)
        f = jcent._class_centers_grid_space(ref, [1, 2, 3, 4, 5]).astype(np.float32)
        m = jcent._class_centers_grid_space(moving, [1, 2, 3, 4, 5]).astype(np.float32)
        jax_fit = _jax_fit(params, 500, f, m)
        jax_jitter = float(np.abs(_jax_fit(scaled, 500, f, m) - jax_fit).max())
        port_fit = tcent.fit_centroid_affine(f, m, params, 500).numpy()
        port_gap = float(np.abs(port_fit - jax_fit).max())

        def mse(t):
            return float(np.mean(((t @ m.T).T - f) ** 2))

        with capsys.disabled():
            print(f"\nphantom {seed}: JAX vs JAX from 1-ulp-scaled draws {jax_jitter:.4g}; "
                  f"port vs JAX {port_gap:.4g}; centroid MSE unregistered "
                  f"{mse(np.eye(4)):.4g}, JAX fit {mse(jax_fit):.4g}, port fit "
                  f"{mse(port_fit):.4g}")
        assert jax_jitter > 1e-2
        assert port_gap < 10 * jax_jitter


def test_register_centroids_refuses_other_dof(centroid_inputs):
    ref, moving, _ = centroid_inputs
    with pytest.raises(ValueError):
        tcent.register_centroids(ref, moving, dof=5)


# ---------------------------------------------------------------- crop

@pytest.mark.parametrize('mode', ['mean', 'minmax'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_crop_around_label_center_matches_jax(seed, mode):
    """Labels bit-equal, the cropped image within 1e-5, the affine equal; a
    non-cubic grid at anisotropic spacing, one axis kept (-1)."""
    label, image, affine = make_heart_phantom((48, 40, 44), seed=seed,
                                              spacing=(1.2, 1.5, 1.1))
    fov_mm, fov_vox = [40.0, 36.0, 30.0], (24, 20, -1)
    lj, ij, aj = jcrop(jnp.asarray(label)[None, None],
                       jnp.asarray(affine, jnp.float32)[None], jnp.asarray(fov_mm),
                       fov_vox, image=jnp.asarray(image)[None, None], center_mode=mode)
    lt, it, at = tcrop(torch.as_tensor(label)[None, None],
                       torch.as_tensor(affine, dtype=torch.float32)[None], fov_mm,
                       fov_vox, image=torch.as_tensor(image)[None, None],
                       center_mode=mode)
    assert lt.shape == (1, 1, 24, 20, 44) and lt.dtype == torch.int32
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), atol=1e-5)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
