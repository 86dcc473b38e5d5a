"""Visualization: slice-input mosaics, frameless image writer, clinical-view sheets.

The port's own copy of the JAX package's ``utils/visualize.py``. matplotlib is
imported inside each plotting function, so the module imports where matplotlib is
missing; the clinical-view sheet samples with the port's torch resampler.

Ports of the reference's logging images (log_utils.py:80-91, run_dl.py:580-595) and
the per-case debug figure (clinical_cardiac_views.py:135-174); the pyvista 3D mesh
notebooks are replaced by matplotlib slice sheets (pyvista is not available).
"""

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    from matplotlib import pyplot as plt
    return plt


def save_frameless_image(image, path, dpi=150, cmap='gray'):
    """Write an image without axes/frames (reference log_utils.py:80-91)."""
    plt = _pyplot()
    image = np.asarray(image, np.float64)
    fig = plt.figure(frameon=False)
    size = np.array(image.shape[:2]) / dpi
    fig.set_size_inches(size[1], size[0])
    ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
    ax.set_axis_off()
    fig.add_axes(ax)
    ax.imshow(image, aspect='auto', cmap=cmap)
    fig.savefig(path, dpi=dpi)
    plt.close(fig)


def slice_input_mosaic(slice_inputs, n_views):
    """Arrange per-case slice argmax maps into one mosaic image.

    Args:
      slice_inputs: (N_cases, n_views*C, Sh, Sw) model inputs.
      n_views: number of views.
    Returns: 2D float array with NaN background, mean image prepended
      (reference run_dl.py:580-592).
    """
    x = np.asarray(slice_inputs)
    n, vc, sh, sw = x.shape
    c = vc // n_views
    views = x.reshape(n, n_views, c, sh, sw).argmax(axis=2)  # (N, V, Sh, Sw)
    mean_img = views.astype(np.float64).mean(axis=0, keepdims=True)
    stack = np.concatenate([mean_img, views], axis=0)        # (N+1, V, Sh, Sw)
    # (V*Sh) x ((N+1)*Sw) grid
    mosaic = stack.transpose(1, 2, 0, 3).reshape(n_views * sh, (n + 1) * sw)
    mosaic = mosaic.astype(np.float64)
    mosaic[mosaic == 0] = np.nan
    return mosaic


def plot_learned_planes(label, nii_affine, case_affines, path, view_names=None,
                        slice_shape=(128, 128), max_points=4000):
    """Render the learned acquisition planes inside the heart in 3D world (mm)
    space — the role of the reference's pyvista notebook
    (the reference's visualize/visualize_mmwhs.ipynb, cells 5-13), in matplotlib
    (pyvista is not in this image).

    Args:
      label: (D, H, W) int segmentation of the (centroid-reoriented) case volume.
      nii_affine: (4, 4) voxel->mm affine of that volume.
      case_affines: one case's entry of an ``affines_*_epx_*.pkl`` dump
        (engine/runner.py _store_epoch_artifacts): dict with
        ``transformed_nii_affines`` (V, 4, 4) — each view slice's voxel->mm affine.
      path: output PNG.
      view_names: optional V names for the legend.
      slice_shape: (H, W) voxel extent of each view plane.
    """
    plt = _pyplot()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    label = np.asarray(label)
    nii_affine = np.asarray(nii_affine, np.float64)
    slice_affs = np.asarray(case_affines['transformed_nii_affines'], np.float64)
    V = slice_affs.shape[0]
    if view_names is None:
        view_names = [f'view {v}' for v in range(V)]

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection='3d')

    # heart voxels -> world mm, thinned to max_points, colored by class
    idx = np.argwhere(label > 0)
    if len(idx):
        keep = np.linspace(0, len(idx) - 1,
                           min(max_points, len(idx))).astype(int)
        idx = idx[keep]
        homo = np.concatenate([idx, np.ones((len(idx), 1))], axis=1)
        world = (nii_affine @ homo.T).T[:, :3]
        classes = label[idx[:, 0], idx[:, 1], idx[:, 2]]
        ax.scatter(world[:, 0], world[:, 1], world[:, 2], c=classes,
                   cmap='viridis', s=2, alpha=0.25, linewidths=0)

    # each learned plane as a translucent quad through its slice corners
    colors = ('#2a78d6', '#eb6834', '#1baf7a', '#8d59c9', '#c9a227', '#d1485f')
    sh, sw = slice_shape
    corners_vox = np.array([[0, 0, 0, 1], [sh - 1, 0, 0, 1],
                            [sh - 1, sw - 1, 0, 1], [0, sw - 1, 0, 1]],
                           np.float64)
    for v in range(V):
        quad = (slice_affs[v] @ corners_vox.T).T[:, :3]
        color = colors[v % len(colors)]
        ax.add_collection3d(Poly3DCollection(
            [quad], facecolors=color, edgecolors=color, alpha=0.3,
            linewidths=1.2, label=view_names[v]))
        ax.plot([], [], color=color, label=view_names[v])  # legend proxy

    ax.set_xlabel('x (mm)'); ax.set_ylabel('y (mm)'); ax.set_zlabel('z (mm)')
    ax.legend(frameon=False, fontsize=8, loc='upper left')
    # cubic world box around the heart so planes aren't distorted
    if len(idx):
        center = world.mean(0)
        half = max(60.0, 0.75 * np.abs(world - center).max())
        for setter, c in zip((ax.set_xlim, ax.set_ylim, ax.set_zlim), center):
            setter(c - half, c + half)
    fig.savefig(path, bbox_inches='tight', dpi=130)
    plt.close(fig)


def save_clinical_views_figure(image, label, volume_affine, view_affines, path,
                               fov_mm=(300.0, 300.0, 1.0), fov_vox=(128, 128, 1)):
    """Render each clinical view's image+label slice into one figure
    (reference clinical_cardiac_views.py:135-174)."""
    import torch
    from acquisition_focus_tpu_torch.ops.resample import nifti_grid_sample

    plt = _pyplot()
    names = [k for k in view_affines if k != 'centroids']
    n_cols = 5
    n_rows = (len(names) + n_cols - 1) // n_cols
    fig, axs = plt.subplots(n_rows, n_cols, figsize=(3 * n_cols, 3 * n_rows))
    axs = np.atleast_1d(axs).ravel()
    for ax in axs:
        ax.axis('off')

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    vol_i, vol_l = f32(image)[None, None], f32(label)[None, None]
    aff = f32(volume_affine)[None]
    for ax, name in zip(axs, names):
        pre = f32(view_affines[name])[None]
        img_slc, _, _ = nifti_grid_sample(vol_i, aff, f32(fov_mm), fov_vox,
                                          is_label=False, pre_grid_sample_affine=pre)
        lbl_slc, _, _ = nifti_grid_sample(vol_l, aff, f32(fov_mm), fov_vox,
                                          is_label=True, pre_grid_sample_affine=pre)
        ax.imshow(np.asarray(img_slc[0, 0, ..., 0]).T[::-1], cmap='gray')
        ax.imshow(np.asarray(lbl_slc[0, 0, ..., 0]).T[::-1], cmap='magma', alpha=0.25,
                  interpolation='none')
        ax.set_title(name)
        ax.axis('off')
    fig.savefig(path, bbox_inches='tight', dpi=100)
    plt.close(fig)


def plot_training_curves(stages, png_path, title='Phantom end-to-end stage sweep'):
    """Two stacked panels (loss / val Dice) of a run's metric streams, the stages
    (``{stage: [metrics.jsonl records]}``) laid out on one global epoch axis with
    boundary markers (the JAX package's ``scripts/train_phantom_e2e.py``
    figure)."""
    plt = _pyplot()
    SURFACE, INK, INK2 = '#fcfcfb', '#0b0b0b', '#52514e'
    C_TRAIN, C_VAL, C_DICE = '#2a78d6', '#eb6834', '#1baf7a'

    order = sorted(stages, key=lambda s: (s == 'ref', s))  # opt_view0.. then ref
    series = {'train_loss': [], 'val_loss': [], 'val_dice': []}
    bounds, x0 = [], 0
    for stage in order:
        per_epoch = {}
        for rec in stages[stage]:
            if rec.get('step') is None:
                continue
            d = per_epoch.setdefault(rec['step'], {})
            for key, name in (('losses/train_loss', 'train_loss'),
                              ('losses/val_loss', 'val_loss'),
                              ('scores/val_mean_oa_exclude_bg_dice', 'val_dice')):
                if key in rec:
                    d[name] = rec[key]
        for i, step in enumerate(sorted(per_epoch)):
            for name in series:
                if name in per_epoch[step]:
                    series[name].append((x0 + i, per_epoch[step][name]))
        bounds.append((x0, x0 + len(per_epoch)))
        x0 += len(per_epoch)

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(9, 5.6), sharex=True,
                                   facecolor=SURFACE, gridspec_kw={'hspace': 0.12})
    for ax in (ax1, ax2):
        ax.set_facecolor(SURFACE)
        for side in ('top', 'right'):
            ax.spines[side].set_visible(False)
        for side in ('left', 'bottom'):
            ax.spines[side].set_color(INK2)
        ax.grid(True, axis='y', color=INK2, alpha=0.15, linewidth=0.6)
        ax.tick_params(colors=INK2, labelsize=8)
        for lo, _ in bounds:
            ax.axvline(lo, color=INK2, alpha=0.3, linewidth=0.8)
    for (lo, hi), name in zip(bounds, order):
        ax1.text((lo + hi) / 2, 1.02, name, transform=ax1.get_xaxis_transform(),
                 ha='center', fontsize=8, color=INK2)

    def plot(ax, name, color, label):
        if series[name]:
            xs, ys = zip(*series[name])
            ax.plot(xs, ys, color=color, linewidth=2, label=label)

    plot(ax1, 'train_loss', C_TRAIN, 'train loss')
    plot(ax1, 'val_loss', C_VAL, 'val loss')
    ax1.set_ylabel('DC+CE loss', fontsize=9, color=INK)
    ax1.legend(frameon=False, fontsize=8, labelcolor=INK, loc='upper right')
    plot(ax2, 'val_dice', C_DICE, 'val Dice (mean, excl. bg)')
    ax2.set_ylabel('Dice', fontsize=9, color=INK)
    ax2.set_ylim(0, 1)
    ax2.set_xlabel('epoch (stage-sweep global)', fontsize=9, color=INK)
    ax2.legend(frameon=False, fontsize=8, labelcolor=INK, loc='upper left')
    fig.suptitle(title, fontsize=10, color=INK, y=0.99)
    fig.savefig(png_path, dpi=150, bbox_inches='tight')
    plt.close(fig)
