"""Train the frozen prescan segmenter (the port's twin of
``scripts/train_segmenter.py``): the 2D U-Net on the 2D slices (axis 0) of a
prepared dataset's hires volumes, with GIN intensity augmentation and, with
``--multires``, a simulated low resolution (a random 1, 1/2, 1/4 or 1/6 shrink,
antialiased, then nearest back up). AdamW at lr 1e-3 and weight decay 1e-5 on the
Dice + CE loss. The checkpoint is a ``torch.save`` file holding
``{'params': state_dict, 'num_classes'}``, which ``engine.segmenter`` serves.

    python -m acquisition_focus_tpu_torch.scripts.train_segmenter \
        --data_dir <prepared files> --out <checkpoint file> [--dataset mmwhs] \
        [--epochs 50] [--steps_per_epoch 50] [--batch 8] [--multires] [--spat 32] \
        [--seed 0] [--device cpu]

Runs on the card unless ``--device cpu`` is given. Slices come from a numpy
generator seeded with ``--seed``, the weights from ``torch.Generator`` seed
``--seed``, and step i's augmentation from a generator keyed by (seed + 1, i).
"""

import argparse
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from acquisition_focus_tpu_torch.ops.resample import image_resize


def sample_slices(dataset, rng, batch, slice_axis=0):
    """Random (image, label) 2D slices from random cases, biased to foreground:
    (batch, H, W, 1) float and (batch, H, W) int numpy arrays."""
    ids = dataset.get_3d_ids()
    imgs, lbls = [], []
    while len(imgs) < batch:
        case = dataset.cases[ids[rng.integers(len(ids))]]
        img, lbl = case['image'], case['label']
        d = rng.integers(img.shape[slice_axis])
        lbl_slc = np.take(lbl, d, axis=slice_axis)
        if lbl_slc.sum() == 0 and rng.random() < 0.7:
            continue  # foreground oversampling
        imgs.append(np.take(img, d, axis=slice_axis))
        lbls.append(lbl_slc)
    return np.stack(imgs)[..., None], np.stack(lbls)


def simulate_lowres(x, generator, zoom_options=(1.0, 1.0 / 2, 1.0 / 4, 1.0 / 6)):
    """Per sample of (B, C, H, W), a zoom drawn uniformly from ``zoom_options``
    (``generator``: a CPU ``torch.Generator``): 'linear' down to
    (max(1, int(H z)), max(1, int(W z))), 'nearest' back to (H, W)."""
    B, C, H, W = x.shape
    choice = torch.randint(len(zoom_options), (B,), generator=generator).tolist()
    out = x.clone()
    for k, z in enumerate(zoom_options):
        sel = [i for i, c in enumerate(choice) if c == k]
        if not sel:
            continue
        h, w = max(1, int(H * z)), max(1, int(W * z))
        lo = image_resize(x[sel], (len(sel), C, h, w), 'linear')
        out[sel] = image_resize(lo, (len(sel), C, H, W), 'nearest')
    return out


def main(argv=None):
    from acquisition_focus_tpu_torch.data.cache import load_or_build
    from acquisition_focus_tpu_torch.data.mrxcat import get_dataset_class
    from acquisition_focus_tpu_torch.engine.checkpoint import save_checkpoint
    from acquisition_focus_tpu_torch.engine.config import load_config
    from acquisition_focus_tpu_torch.engine.losses import dice_ce_loss
    from acquisition_focus_tpu_torch.engine.runner import seeded_generator
    from acquisition_focus_tpu_torch.engine.train import init_params, resolve_device
    from acquisition_focus_tpu_torch.models.segmentation import SegUnet2D, gin_aug

    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', required=True)
    p.add_argument('--out', required=True, help='checkpoint file to write')
    p.add_argument('--dataset', default='mmwhs')
    p.add_argument('--epochs', type=int, default=50)
    p.add_argument('--steps_per_epoch', type=int, default=50)
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--multires', action='store_true',
                   help='add discrete low-res simulation (GIN_MultiRes)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--spat', type=int, default=None,
                   help='override hires/prescan FOV to spat voxels @ 1.5 mm '
                        "(the smoke configs' 32 trains at smoke scale)")
    p.add_argument('--cache_dir', default='.cache', help='dataset cache directory')
    p.add_argument('--device', default=None, help='torch device (default: the card)')
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    overrides = {'dataset': [args.dataset, args.data_dir]}
    if args.spat:
        fov = args.spat * 1.5
        overrides.update(
            hires_fov_mm=[fov] * 3, hires_fov_vox=[args.spat] * 3,
            prescan_fov_mm=[fov] * 3, prescan_fov_vox=[args.spat] * 3,
            slice_fov_mm=[fov, fov, 1.5], slice_fov_vox=[args.spat, args.spat, 1])
    config = load_config(overrides=overrides)
    ds = load_or_build(get_dataset_class(args.dataset), args.data_dir, config,
                       state='train', cache_dir=args.cache_dir, device=device)
    num_classes = len(ds.label_tags)
    print(f"training segmenter on {len(ds)} cases, {num_classes} classes")

    model = SegUnet2D(num_classes).to(device)
    init_params(model, nn.ModuleList(), torch.Generator().manual_seed(args.seed))
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-5)
    rng = np.random.default_rng(args.seed)

    step_id, times, loss = 0, [], float('nan')
    for epoch in range(args.epochs):
        losses = []
        for _ in range(args.steps_per_epoch):
            t0 = time.perf_counter()
            x, y = sample_slices(ds, rng, args.batch)
            x = torch.as_tensor(x, device=device).permute(0, 3, 1, 2)
            y = torch.as_tensor(y, device=device).long()
            gen = seeded_generator(args.seed + 1, step_id)
            x = gin_aug(x, gen)
            if args.multires:
                x = simulate_lowres(x, gen)
            onehot = F.one_hot(y, num_classes).movedim(-1, 1).float()
            loss_t = dice_ce_loss(model(x), onehot)
            opt.zero_grad(set_to_none=True)
            loss_t.backward()
            opt.step()
            loss = float(loss_t.detach())               # synchronizes
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            step_id += 1
        print(f"epoch {epoch}: loss {np.mean(losses):.4f}")

    save_checkpoint(args.out, {'params': {k: v.cpu() for k, v in model.state_dict().items()},
                               'num_classes': num_classes})
    s_step = float(np.mean(times[1:])) if len(times) > 1 else float('nan')
    print(f"saved segmenter checkpoint to {args.out}; {step_id} steps, "
          f"{s_step:.4f} s/step after the first, final loss {loss:.4f}")
    return {'steps': step_id, 's_step': s_step, 'final_loss': loss}


if __name__ == '__main__':
    main()
