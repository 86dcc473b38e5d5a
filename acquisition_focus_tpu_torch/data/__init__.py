"""Data for the port. ``synthetic`` is the port's copy of the JAX package's phantom
generator (tests hold the two bit-equal), so both packages draw the same labels
from a seed. ``base_dataset`` holds the batch half of the dataset layer, which
``cache.py::load_or_build`` (a copy of the JAX package's, same key and format)
fills from the dataset cache; the dataset build is not ported yet."""

from acquisition_focus_tpu_torch.data.synthetic import make_heart_phantom

__all__ = ['make_heart_phantom']
