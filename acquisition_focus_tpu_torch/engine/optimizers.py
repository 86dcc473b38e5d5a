"""Optimizers and LR schedules of the reconstruction and transform models (torch
port of ``acquisition_focus_tpu/engine/optimizers.py``):

  reconstruction: AdamW(lr, weight_decay=0.01), ExponentialLR(gamma=0.995) per epoch;
  transform:      AdamW(2*lr, weight_decay=0.1),
                  CosineAnnealingWarmRestarts(T_0=epochs//4+1, T_mult=1) per epoch;
  (E)Pix2Vox:     Adam, merger 1e-4 and everything else 1e-3,
                  MultiStepLR(milestones=[150], gamma=0.5) per epoch.

Schedules are keyed to the update count through ``LambdaLR``: update k (0-based)
runs at base_lr * factor(k), with the epoch taken as k // updates_per_epoch. Each
factory returns ``(optimizer, scheduler)``; a step calls ``optimizer.step()`` then
``scheduler.step()``.
"""

import math

import torch


def exponential_epoch_factor(gamma, updates_per_epoch):
    def factor(count):
        return gamma ** (count // max(1, updates_per_epoch))
    return factor


def cosine_warm_restarts_epoch_factor(t_0, updates_per_epoch):
    def factor(count):
        t_cur = (count // max(1, updates_per_epoch)) % t_0
        return (1.0 + math.cos(math.pi * t_cur / t_0)) / 2.0
    return factor


def _adamw(params, lr, weight_decay, factor):
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor or (lambda count: 1.0))


def make_reconstruction_optimizer(params, lr, updates_per_epoch, use_scheduling=True):
    factor = exponential_epoch_factor(0.995, updates_per_epoch) if use_scheduling else None
    return _adamw(params, lr, 0.01, factor)


def make_transform_optimizer(params, lr, epochs, updates_per_epoch, use_scheduling=True):
    t_0 = int(epochs / 4) + 1
    factor = (cosine_warm_restarts_epoch_factor(t_0, updates_per_epoch)
              if use_scheduling else None)
    return _adamw(params, 2.0 * lr, 0.1, factor)


def multistep_epoch_factor(milestone, gamma, updates_per_epoch):
    def factor(count):
        return gamma if count // max(1, updates_per_epoch) >= milestone else 1.0
    return factor


def make_epix2vox_optimizer(model, updates_per_epoch, use_scheduling=True):
    """The (E)Pix2Vox reconstruction optimizer: Adam (betas 0.9/0.999, eps 1e-8, no
    weight decay) over two param groups, everything but the merger at 1e-3 (group
    0) and the merger at 1e-4 (group 1), halved from epoch 150 on."""
    merger = [p for n, p in model.named_parameters() if n.startswith('merger.')]
    main = [p for n, p in model.named_parameters() if not n.startswith('merger.')]
    opt = torch.optim.Adam([{'params': main, 'lr': 1e-3}, {'params': merger, 'lr': 1e-4}],
                           betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    factor = (multistep_epoch_factor(150, 0.5, updates_per_epoch) if use_scheduling
              else (lambda count: 1.0))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
