"""The device mesh over ``torch.distributed``: data and feature parallelism
(``mesh.py``: the mesh, the batch and parameter rules; ``collectives.py``: the
collectives; ``feature_parallel.py``: the feature-sharded U-Net modules)."""

from acquisition_focus_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_shardings, make_mesh, replicate, shard_batch, shard_opt_state, shard_params)
