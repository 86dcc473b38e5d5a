"""The plain training step: the reference that decides `correct`.

One step is one optimizer update over the macrobatch's microbatches. Per
microbatch: the one-hot label volume; each view's plane turned by the step's
augmentation draws; with learned views, each active view's prescan (the label
resampled along its plane, no gradient) through its affine transform module,
the frozen views' without a gradient; the slices, a trilinear sample of the
label along view @ theta; the reconstruction model; Dice + cross-entropy
(nnU-Net's ``DC_and_CE_loss``: softmax, per-sample dice over all classes with
smoothing 1, CE - dice), on background/foreground sums where the labels are
binarized. The gradient is the mean of the microbatches'. The frozen views'
modules get no update; the others take AdamW (decoupled weight decay) or Adam.

It imports nothing of the program under test: the same equations, written once
more in plain PyTorch, on weights and inputs that the benchmark makes.
"""

import importlib

import torch
import torch.nn.functional as F

from benchmark.reference import atm as atm_ref
from benchmark.reference.geometry import augmentation_affines, compose, nifti_resample
from benchmark.reference.precision import Precision


def model_module(name):
    return importlib.import_module(f'benchmark.reference.{name}')


def stage_spec(config, num_classes, stage):
    """What the step computes, from the configuration's keys and the stage of the
    sweep: 'opt_view<i>' (views 0..i active, only view i's module trains) or 'ref'
    (every view active, the planes as given, no module runs)."""
    n_views = len(config['base_views'])
    for key, plain in (('affine_theta_optim_method', 'R6-vector'),
                       ('do_augment_recon_orientation', False), ('optimize_lv_only', False),
                       ('rotate_slice_to_min_principle', False),
                       ('label_slice_type', 'from-gt')):
        if config.get(key, plain) != plain:
            raise ValueError(f"the reference computes {key}={plain!r} only")
    if stage == 'ref':
        active, mode, learned = n_views, 'opt-none', False
    elif stage.startswith('opt_view'):
        active, mode, learned = int(stage[8:]) + 1, 'opt-current-fix-previous', True
    else:
        raise ValueError(f"unknown stage {stage!r}")
    keys = ('batch_size', 'num_grad_accum_steps', 'lr', 'hires_fov_vox', 'slice_fov_mm',
            'slice_fov_vox', 'prescan_fov_mm', 'prescan_fov_vox', 'offset_clip_value',
            'zoom_clip_value', 'model_type', 'use_binarized_labels')
    spec = {k: config[k] for k in keys}
    spec.update(n_views=n_views, num_classes=num_classes, n_active_views=active,
                view_optimization_mode=mode, use_affine_theta=learned,
                augment_input=bool(config['do_augment_input_orientation']),
                augment_strength=float(config['sample_augment_strength']),
                base_features=list(config['base_features']),
                locnet_width=int(config['locnet_width']))
    return spec


def build(spec, reference, device):
    """(reconstruction model, list of n_views transform modules) on ``device``."""
    recon = model_module(reference).Model(spec).to(device)
    atms = torch.nn.ModuleList([
        atm_ref.AffineTransformModule(spec['num_classes'], spec['prescan_fov_vox'][0],
                                      spec['offset_clip_value'], spec['zoom_clip_value'],
                                      spec['locnet_width'])
        for _ in range(spec['n_views'])]).to(device)
    return recon, atms


def init_kinds(spec, reference, recon, atms):
    """{'recon.<name>' | 'atms.<name>': (kind, std)}, in a fixed order."""
    kinds = {f'recon.{k}': v for k, v in model_module(reference).init_kinds(recon).items()}
    kinds.update({f'atms.{k}': v for k, v in atm_ref.init_kinds(atms).items()})
    return kinds


def train_mask(spec):
    """Which active views' transform modules train this stage."""
    A = spec['n_active_views']
    if not spec['use_affine_theta']:
        return [False] * A
    if spec['view_optimization_mode'] == 'opt-all':
        return [True] * A
    if spec['view_optimization_mode'] == 'opt-current-fix-previous':
        return [False] * (A - 1) + [True]
    return [False] * A


def dice_ce(logits, target):
    probs = torch.softmax(logits, dim=1)
    dims = tuple(range(2, logits.ndim))
    tp = (probs * target).sum(dims)
    fp = (probs * (1.0 - target)).sum(dims)
    fn = ((1.0 - probs) * target).sum(dims)
    dice = ((2.0 * tp + 1.0) / (2.0 * tp + fp + fn + 1.0)).mean()
    ce = -(target * torch.log_softmax(logits, dim=1)).sum(1).mean()
    return ce - dice


def _binarize(x):
    return torch.cat([x[:, :1], x[:, 1:].sum(1, keepdim=True)], dim=1)


def hard_dice(logits, target):
    """(B, C) Dice of the channel argmax (first maximum on ties) against the
    one-hot target, NaN where the target class is empty."""
    pred = F.one_hot(logits.argmax(dim=1), logits.shape[1]).movedim(-1, 1).float()
    dims = tuple(range(2, logits.ndim))
    inter = (pred * target).sum(dims)
    dice = 2.0 * inter / torch.clamp(pred.sum(dims) + target.sum(dims), min=1e-8)
    return torch.where(target.sum(dims) > 0, dice, torch.full_like(dice, float('nan')))


def micro_loss(spec, reference, recon, atms, micro, generator, prec, dice=None,
               thetas_out=None, loss_rows=None):
    """Loss of one microbatch: 'label' (B, D, H, W), 'nii_affine' (B, 4, 4),
    'view_affines' (V, B, 4, 4); augmentation draws from ``generator``. Appends
    the microbatch's hard Dice (B, C) to the list ``dice``, and each active view's
    learned theta (B, 4, 4) to ``thetas_out``, if given. ``loss_rows``: the loss
    over the first rows only, the forward and the Dice over all."""
    A, V = spec['n_active_views'], spec['n_views']
    onehot = F.one_hot(micro['label'].long(), spec['num_classes']).movedim(-1, 1).float()
    B = onehot.shape[0]
    nii = micro['nii_affine'].float()
    views = micro['view_affines'][:A].float()
    if spec['augment_input']:
        aug = augmentation_affines(generator, B, spec['augment_strength'], onehot.device)
        views = compose(views, aug[None])
    if spec['use_affine_theta']:
        with torch.no_grad():
            prescan, _, _ = nifti_resample(onehot, nii, spec['prescan_fov_mm'],
                                           spec['prescan_fov_vox'], views.reshape(A * B, 4, 4))
        prescan = prescan.reshape((A, B) + tuple(prescan.shape[1:]))
        thetas = []
        for v, trains in enumerate(train_mask(spec)):
            with torch.set_grad_enabled(trains):
                thetas.append(atms[v](prescan[v], prec))
        if thetas_out is not None:
            thetas_out += [t.detach().cpu() for t in thetas]
        thetas = torch.stack(thetas)
    else:
        thetas = torch.eye(4, device=onehot.device).expand(A, B, 4, 4)
    slices, grid, _ = nifti_resample(onehot, nii, spec['slice_fov_mm'], spec['slice_fov_vox'],
                                     compose(views, thetas).reshape(A * B, 4, 4))
    Sh, Sw, _ = spec['slice_fov_vox']
    if (Sh, Sw) != tuple(spec['hires_fov_vox'][:2]):
        raise ValueError("the reference takes slices at the volume's in-plane grid")
    slices = slices.reshape(A, B, -1, Sh, Sw)
    grid = grid.reshape(A, B, 4, 4)
    idx = list(range(A)) + [A - 1] * (V - A)
    b_input = torch.cat(list(slices[idx]), dim=1)
    y = model_module(reference).logits(recon, b_input, grid[idx], spec, prec)
    target = onehot
    if spec['use_binarized_labels']:
        target, y = _binarize(target), _binarize(y)
    if dice is not None:
        with torch.no_grad():
            dice.append(hard_dice(y, target))
    return dice_ce(y[:loss_rows], target[:loss_rows])


class Optimizer:
    """Adam / AdamW (betas 0.9, 0.999, eps 1e-8) written out, float32 state."""

    def __init__(self, groups):
        self.groups = groups
        self.state = {}
        self.t = 0

    def step(self):
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        with torch.no_grad():
            for g in self.groups:
                for name, p in g['params']:
                    if p.grad is None:
                        continue
                    grad = p.grad
                    if g['weight_decay'] and g.get('decoupled', True):
                        p.mul_(1.0 - g['lr'] * g['weight_decay'])
                    m, v = self.state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
                    m.mul_(b1).add_(grad, alpha=1.0 - b1)
                    v.mul_(b2).add_(grad * grad, alpha=1.0 - b2)
                    p.sub_(g['lr'] / c1 * m / (torch.sqrt(v) / c2 ** 0.5 + 1e-8))


def train_steps(spec, reference, weights, batches, generators, precision='float32',
                fault=None):
    """Drive the reference through the given steps from ``weights``
    ({'recon.<name>' | 'atms.<name>': tensor}, which it copies).

    ``batches``: one dict per step of device tensors with a leading microbatch
    axis ('view_affines' (accum, V, B, 4, 4)); ``generators``: one augmentation
    generator per step. ``fault``: None, 'half_batch' (each microbatch's loss,
    and so its gradient, over its first half of rows only, the forward and the
    Dice over all) or 'atm_reversed' (the training transform modules' gradient
    turned the other way before each update), faults that `correct` must reject.
    Returns {'loss': [per
    step], 'grad': {leaf: first step's gradient norm, 0 for a leaf no optimizer
    updates}, 'grad_vec': {updated leaf: first step's gradient, on the host},
    'change': {leaf: norm of the change over all steps}, 'updated': sorted names
    of the leaves an optimizer updates, 'dice': the first step's hard Dice per
    sample and class, (accum * B, C), 'thetas': per step, the learned thetas, one
    (B, 4, 4) list per view and microbatch, in the order they run, 'theta_trains':
    for each of a step's thetas, whether its module trains};
    every parameter is a leaf, named as in ``weights``."""
    device = next(iter(weights.values())).device
    recon, atms = build(spec, reference, device)
    with torch.no_grad():
        for prefix, module in (('recon', recon), ('atms', atms)):
            for n, p in module.named_parameters():
                p.copy_(weights[f'{prefix}.{n}'])
    prec = Precision(precision)
    mask = train_mask(spec) + [False] * (spec['n_views'] - spec['n_active_views'])
    groups = [dict(g, params=[(f'recon.{n}', p) for n, p in g['params']])
              for g in model_module(reference).optimizer_groups(recon, spec, spec['lr'])]
    trans = [(f'atms.{n}', p) for n, p in atms.named_parameters()
             if mask[int(n.split('.')[0])]]
    if trans:
        groups.append(dict(params=trans, lr=2.0 * spec['lr'], weight_decay=0.1))
    opt = Optimizer(groups)
    leaves = {f'{prefix}.{n}': p for prefix, module in (('recon', recon), ('atms', atms))
              for n, p in module.named_parameters()}
    updated = sorted(n for g in groups for n, _ in g['params'])
    start = {n: p.detach().clone() for n, p in leaves.items()}
    out = {'loss': [], 'grad': {}, 'change': {}, 'updated': updated, 'thetas': [],
           'theta_trains': train_mask(spec) * batches[0]['label'].shape[0]
           if spec['use_affine_theta'] else []}
    for k, (batch, gen) in enumerate(zip(batches, generators)):
        for p in leaves.values():
            p.grad = None
        accum = batch['label'].shape[0]
        losses, dice, thetas = [], [], []
        for i in range(accum):
            micro = {key: v[i] for key, v in batch.items()}
            rows = micro['label'].shape[0] // 2 if fault == 'half_batch' else None
            loss = micro_loss(spec, reference, recon, atms, micro, gen, prec, dice, thetas,
                              rows)
            (loss / accum).backward()
            losses.append(float(loss.detach()))
        out['loss'].append(sum(losses) / accum)
        out['thetas'].append([t.tolist() for t in thetas])
        if k == 0:
            out['dice'] = torch.cat(dice).cpu().tolist()
            out['grad'] = {n: float(leaves[n].grad.norm()) if n in updated else 0.0
                           for n in leaves}
            out['grad_vec'] = {n: leaves[n].grad.detach().to('cpu', copy=True)
                               for n in updated}
        if fault == 'atm_reversed':
            for _, p in trans:
                p.grad.neg_()
        opt.step()
    out['change'] = {n: float((p.detach() - start[n]).norm()) for n, p in leaves.items()}
    return out
