"""The 'model' split's gathers along channels across ranks
(``torch_mesh_workers.channel_gathers``): a channels-last slab gathered along
its channels stays channels-last and equals ``torch.cat`` of the ranks' slabs,
with the backward of each gather and ``copy_to_model``'s strides. On gloo ranks
here, and under NCCL on as many GPUs (``cuda``), where the hybrid U-Net's and
(E)Pix2Vox's four-GPU meshes gather:

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_collectives_ranks.py -q

This module imports no JAX.
"""

import pytest
import torch

import torch_mesh_workers as workers
from acquisition_focus_tpu_torch.parallel.mesh import spawn_ranks


def gathers(tmp_path, n, backend):
    spawn_ranks(workers.world, n, args=([('channel_gathers', n)], str(tmp_path)),
                backend=backend, threads=1 if backend == 'gloo' else None)
    return torch.load(tmp_path / '0.pt', weights_only=False)


@pytest.mark.parametrize('n', [2, 4])
def test_channel_gathers_on_gloo_ranks(tmp_path, n):
    got = gathers(tmp_path, n, 'gloo')
    assert got['mismatches'] == 0, got


@pytest.mark.cuda
@pytest.mark.parametrize('n', [2, 4])
def test_channel_gathers_on_gpus(tmp_path, n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    got = gathers(tmp_path, n, 'nccl')
    assert got['mismatches'] == 0, got
