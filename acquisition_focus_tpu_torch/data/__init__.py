"""Data for the port: the NIfTI reader/writer (``nifti_io``), the phantom generator
and dataset writer (``synthetic``), offline preprocessing (``preprocess``), the
dataset build and batch layer (``base_dataset``, ``mmwhs``, ``mrxcat``) and the
dataset cache (``cache.load_or_build``). ``nifti_io``, ``synthetic`` and ``cache``
are the port's own copies of the JAX package's plain-Python modules (tests hold
them equal)."""

from acquisition_focus_tpu_torch.data.synthetic import make_heart_phantom

__all__ = ['make_heart_phantom']
