"""Data for the port. The phantom generator is the JAX package's own numpy-only
module (it imports no jax), shared so both packages draw the same labels from a
seed. ``base_dataset`` holds the batch half of the dataset layer, which the JAX
package's jax-free ``data/cache.py::load_or_build`` fills from its dataset cache;
the dataset build is not ported yet."""

from acquisition_focus_tpu.data.synthetic import make_heart_phantom

__all__ = ['make_heart_phantom']
