"""Offline tools of the port, run with ``python -m acquisition_focus_tpu_torch.scripts.<name>``."""
