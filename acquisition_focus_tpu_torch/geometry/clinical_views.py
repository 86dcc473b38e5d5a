"""Clinical view geometry (torch port of
``acquisition_focus_tpu/geometry/clinical_views.py``). Only ``get_class_volumes``,
the evaluation's volume metric, is ported; the view derivation belongs to the
dataset build, which is not."""

import torch

_UNITS = {'mm3': 1.0, 'cm3': 1e-3, 'ml': 1e-3, 'l': 1e-6}


def get_class_volumes(b_label, b_spacing, num_classes, unit='ml'):
    """Per-class volumes of a batch of dense label maps.

    Args:
      b_label: (B, D, H, W) integer labels. b_spacing: (B, 3) mm voxel spacing.
    Returns: (B, num_classes) float32 volumes in ``unit``.
    """
    if unit not in _UNITS:
        raise ValueError(unit)
    counts = torch.stack([(b_label == c).sum(dim=(1, 2, 3)) for c in range(num_classes)],
                         dim=1)
    voxel_mm3 = torch.as_tensor(b_spacing, dtype=torch.float32,
                                device=b_label.device).prod(dim=-1)
    return counts.float() * voxel_mm3[:, None] * _UNITS[unit]
