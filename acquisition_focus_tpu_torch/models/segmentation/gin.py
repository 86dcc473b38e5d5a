"""GIN (global intensity non-linear) augmentation (torch port of
``acquisition_focus_tpu/models/segmentation/gin.py``): a shallow stack of random
3x3 convs with LeakyReLU 0.2 maps the image through a random intensity transform;
the result is alpha-blended with the input and rescaled to the input's per-sample
Frobenius norm. Nothing is learned.

The draws and the arithmetic are apart: :func:`gin_draws` draws the kernels
(He-scaled normals) and the per-sample alpha from a ``torch.Generator``;
:func:`gin_apply` applies given ones, so the tests can feed it the JAX package's
draws; :func:`gin_aug` does both.
"""

import math

import torch
import torch.nn.functional as F


def gin_draws(x_shape, generator, n_layers=4, interm_channels=2, kernel_size=3,
              alpha_range=(0.0, 1.0)):
    """Kernels ((Co, Ci, k, ...) per layer, float32 on the CPU) and alpha (B, 1, ...)
    for a channels-first batch of shape ``x_shape`` (2D or 3D spatial)."""
    B, C = x_shape[:2]
    nd = len(x_shape) - 2
    kernels, ci = [], C
    for i in range(n_layers):
        co = C if i == n_layers - 1 else interm_channels
        w = torch.randn((co, ci) + (kernel_size,) * nd, generator=generator)
        kernels.append(w * math.sqrt(2.0 / (ci * kernel_size ** nd)))
        ci = co
    lo, hi = alpha_range
    alpha = lo + (hi - lo) * torch.rand((B,) + (1,) * (nd + 1), generator=generator)
    return kernels, alpha


def gin_apply(x, kernels, alpha):
    """The GIN transform of ``x`` (B, C, spatial...) with given ``kernels`` and
    ``alpha``: LeakyReLU 0.2 after every conv but the last, 'SAME' (odd kernels:
    symmetric) padding; returns ``x``'s shape and dtype."""
    conv = F.conv2d if x.ndim == 4 else F.conv3d
    h = x.float()
    for i, w in enumerate(kernels):
        w = w.to(h.device, torch.float32)
        h = conv(h, w, padding=w.shape[-1] // 2)
        if i < len(kernels) - 1:
            h = torch.where(h >= 0, h, 0.2 * h)
    alpha = alpha.to(h.device, torch.float32)
    xf = x.float()
    mixed = alpha * h + (1.0 - alpha) * xf
    axes = tuple(range(1, x.ndim))
    x_norm = torch.sqrt((xf ** 2).sum(axes, keepdim=True))
    m_norm = torch.sqrt((mixed ** 2).sum(axes, keepdim=True))
    return (mixed * x_norm / torch.clamp(m_norm, min=1e-8)).to(x.dtype)


def gin_aug(x, generator, **kwargs):
    """A random GIN transform of ``x``, drawn from ``generator`` (a CPU
    ``torch.Generator``); ``kwargs``: those of :func:`gin_draws`."""
    kernels, alpha = gin_draws(tuple(x.shape), generator, **kwargs)
    return gin_apply(x, kernels, alpha)
