"""2D segmentation U-Net of the frozen prescan segmenter (torch port of
``acquisition_focus_tpu/models/segmentation/unet2d.py``).

(B, C_in, H, W) -> (B, num_classes, H, W) logits. Per level two blocks of 3x3 conv,
instance norm with scale and bias, LeakyReLU 0.01; the first block of every level
after the first has stride 2 with flax's 'SAME' padding, which pads an even input
(0, 1) where torch's symmetric padding would pad (1, 1). The up path is a 2x2
stride-2 transposed conv, a skip concat and two blocks; the head is a 1x1 conv.
Everything computes in float32; the norms are ``InstanceNorm2d(affine=True)``, as
in the port's hybrid U-Net (``PARITY.md``). Module names follow the flax params',
so ``convert.segunet_state_dict`` maps them one to one.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from acquisition_focus_tpu_torch.models.localization import leaky_relu

FEATURES = (32, 64, 128, 256, 512)


def _same_pad(x, stride):
    """flax's 'SAME' padding of a 3x3 conv: (total // 2, total - total // 2) per
    axis."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SegUnet2D(nn.Module):
    def __init__(self, num_classes, features=FEATURES, in_channels=1):
        super().__init__()
        self.features = tuple(features)
        self.strides = {}

        def block(name, ci, co, stride):
            self.add_module(f'{name}_conv', nn.Conv2d(ci, co, 3, stride=stride))
            self.add_module(f'{name}_norm', nn.InstanceNorm2d(co, eps=1e-5, affine=True))
            self.strides[name] = stride

        ci = in_channels
        for s, f in enumerate(self.features):
            block(f'enc{s}a', ci, f, 1 if s == 0 else 2)
            block(f'enc{s}b', f, f, 1)
            ci = f
        for s in range(len(self.features) - 2, -1, -1):
            f = self.features[s]
            self.add_module(f'dec{s}_up', nn.ConvTranspose2d(ci, f, 2, stride=2))
            block(f'dec{s}a', 2 * f, f, 1)
            block(f'dec{s}b', f, f, 1)
            ci = f
        self.seg_head = nn.Conv2d(ci, num_classes, 1)

    def _block(self, name, x):
        x = getattr(self, f'{name}_conv')(_same_pad(x, self.strides[name]))
        return leaky_relu(getattr(self, f'{name}_norm')(x))

    def forward(self, x):
        skips = []
        for s in range(len(self.features)):
            x = self._block(f'enc{s}b', self._block(f'enc{s}a', x))
            skips.append(x)
        y = skips[-1]
        for s in range(len(self.features) - 2, -1, -1):
            y = torch.cat([getattr(self, f'dec{s}_up')(y), skips[s]], dim=1)
            y = self._block(f'dec{s}b', self._block(f'dec{s}a', y))
        return self.seg_head(y)
