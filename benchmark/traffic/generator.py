"""The one generator of the benchmark's training traffic, driven by a traffic
file (``benchmark/traffic/<name>.json``) and ``--seed``.

Cases are heart phantoms with the MMWHS labels (background, MYO, LV, RV, LA, RA):
an LV ellipsoid in a MYO shell open at the base, an RV beside it, LA and RA at the
base, about a long axis tilted by a seeded rotation. This is a frozen copy of the
phantom that the program's full-length runs train on, computed on the device in
float64. Each case's view planes are long-axis planes through the label's
centroid, each turned about the long axis by a seeded angle: planes that cut the
chambers as a 2- or 4-chamber view does, without the program's plane search.

Steps take macrobatches in a seeded order, as the program's runner does: per
epoch a permutation of the pool, cut into macrobatches of ``accum * batch``
cases, the last incomplete one dropped. The augmentation generator of step k is
a CPU ``torch.Generator`` keyed by (seed, k).
"""

import math

import numpy as np
import torch


def _case_rng(seed, index):
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(index)]))


def _axis_angle(axis, angle):
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def phantom(shape, rng, tilt, device):
    """(label (D, H, W) int32 on ``device``, long axis (3,) in (d, h, w) order)."""
    d, h, w = shape
    rot = _axis_angle(rng.normal(size=3), tilt * rng.uniform(0.5, 1.0))
    axis = rot @ np.array([1.0, 0.0, 0.0])
    u = np.cross(axis, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    f64 = dict(dtype=torch.float64, device=device)
    center = np.array([d, h, w]) / 2.0
    gd = torch.arange(d, **f64)[:, None, None] - center[0]
    gh = torch.arange(h, **f64)[None, :, None] - center[1]
    gw = torch.arange(w, **f64)[None, None, :] - center[2]

    def along(vec):
        return gd * vec[0] + gh * vec[1] + gw * vec[2]

    ca, cu, cv = along(axis), along(u), along(v)
    s = min(shape) / 96.0
    lv_len, lv_rad, myo_th = 26 * s, 12 * s, 4 * s
    lv = (ca / lv_len) ** 2 + (cu / lv_rad) ** 2 + (cv / lv_rad) ** 2 <= 1.0
    myo = (((ca / (lv_len + myo_th)) ** 2 + (cu / (lv_rad + myo_th)) ** 2
            + (cv / (lv_rad + myo_th)) ** 2 <= 1.0) & ~lv & (ca < lv_len * 0.55))
    rv_c = (lv_rad + myo_th + 9 * s) * u - 2 * s * axis
    rv = (((ca - rv_c @ axis) / (20 * s)) ** 2 + ((cu - rv_c @ u) / (9 * s)) ** 2
          + ((cv - rv_c @ v) / (11 * s)) ** 2 <= 1.0)

    def ball(c, r):
        return (gd - c[0]) ** 2 + (gh - c[1]) ** 2 + (gw - c[2]) ** 2 <= r * r

    la = ball((lv_len + 8 * s) * axis, 9 * s)
    ra = ball((lv_len + 7 * s) * axis + (lv_rad + 8 * s) * u, 8 * s)
    label = torch.zeros(shape, dtype=torch.int32, device=device)
    label[myo] = 1
    label[lv] = 2
    label[rv & (label == 0)] = 3
    label[la & (label == 0)] = 4
    label[ra & (label == 0)] = 5
    return label, axis


def view_planes(label, axis, n_views, rng, turn):
    """(n_views, 4, 4) grid-space plane affines: the plane's normal in column 0,
    the long axis in column 1, the third direction in column 2 (all in (x->W,
    y->H, z->D) order), the translation the foreground centroid in grid
    coordinates 2c / N - 1; each plane turned about the long axis by an angle
    uniform in ``turn`` (radians)."""
    shape = np.array(label.shape, np.float64)
    idx = torch.nonzero(label > 0).double()
    centroid = idx.mean(0).cpu().numpy()
    a = axis / np.linalg.norm(axis)
    ref = np.array([0.0, 0.0, 1.0]) if abs(a[2]) < 0.9 else np.array([0.0, 1.0, 0.0])
    e1 = np.cross(a, ref)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(a, e1)
    out = np.zeros((n_views, 4, 4))
    for k in range(n_views):
        phi = rng.uniform(*turn)
        two = math.cos(phi) * e1 + math.sin(phi) * e2
        normal = np.cross(a, two)
        pix = np.stack([two, a, normal])            # rows in (d, h, w) order
        out[k, :3, :3] = pix[::-1, ::-1].T
        out[k, :3, 3] = (2.0 * centroid / shape - 1.0)[::-1]
        out[k, 3, 3] = 1.0
    return out.astype(np.float32)


def make_pool(traffic, n_views, fov_mm, fov_vox, seed, device):
    """The cases of a run: a list of host dicts 'label' (D, H, W) int32,
    'nii_affine' (4, 4) float32, 'view_affines' (V, 4, 4) float32."""
    shape = tuple(int(v) for v in fov_vox)
    spacing = [m / v for m, v in zip(fov_mm, fov_vox)]
    nii = np.diag(spacing + [1.0])
    nii[:3, 3] = -np.asarray(spacing) * np.array(shape) / 2.0
    pool = []
    for i in range(int(traffic['pool_cases'])):
        rng = _case_rng(seed, i)
        label, axis = phantom(shape, rng, float(traffic['tilt']), device)
        views = view_planes(label, axis, n_views, rng, traffic['view_turn'])
        pool.append({'label': label.cpu().numpy(), 'nii_affine': nii.astype(np.float32),
                     'view_affines': views})
    return pool


def macrobatches(n_cases, accum, batch, seed):
    """Endless seeded order of macrobatches: lists of ``accum * batch`` case ids."""
    macro = accum * batch
    epoch = 0
    while True:
        order = _case_rng(seed, 1_000_000 + epoch).permutation(n_cases)
        for start in range(0, n_cases - macro + 1, macro):
            yield [int(i) for i in order[start:start + macro]]
        epoch += 1


def stage(pool, ids, accum, batch):
    """Host arrays of one macrobatch, as the runner stages them: 'label' (accum, B,
    D, H, W), 'nii_affine' (accum, B, 4, 4), 'view_affines' (accum, V, B, 4, 4)."""
    cases = [pool[i] for i in ids]
    label = np.stack([c['label'] for c in cases])
    nii = np.stack([c['nii_affine'] for c in cases])
    views = np.stack([c['view_affines'] for c in cases], axis=1)      # (V, n, 4, 4)
    return {'label': label.reshape((accum, batch) + label.shape[1:]),
            'nii_affine': nii.reshape(accum, batch, 4, 4),
            'view_affines': views.reshape((views.shape[0], accum, batch, 4, 4))
            .transpose(1, 0, 2, 3, 4)}


def augment_generator(seed, step):
    """The CPU generator of step ``step``'s augmentation draws."""
    state = np.random.SeedSequence([int(seed), 2_000_000 + int(step)]).generate_state(
        1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))
