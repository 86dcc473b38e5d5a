"""(E)Pix2Vox's float32 ``train_step`` at the model's full size (128^3) on
{'data': 2} and {'model': 2} of two gloo ranks against the port in one process;
a file of its own so that a second test worker runs it.

The update, the split, Adam's moments and the replicas as
``test_torch_epix2vox_mesh.py`` holds them (its ``check_update``): each updated
parameter is the first Adam step of the mesh's own gathered gradient, the split
is the rule's, the moments have the full parameters' shapes, the fixed views'
ATMs are one process's bit for bit, and the replicated parameters are bit-equal
on every rank. The loss and the
gradients are held at the JAX package's mesh bound in float64 only: in float32
on the CPU one process alone strays further (here a mesh's loss sits 1.3e-4 and
2.2e-4 of itself from one process's, both in float32), and the model in float64
at full size takes ~19 GB and ~3 min per process here, since the merger's 3^3
convs over (B·V, 9, 128^3) take the CPU's im2col path in float64. So the float64
values are compared with the decoder narrowed on these meshes
(``test_torch_epix2vox_mesh.py``) and at full size on four GPUs
(``scripts/smoke_mesh.py --cases epix2vox``).
"""

import pytest
import torch

from test_torch_epix2vox_mesh import check_update, run_worlds

FULL_CASES = ('data2', 'model2')


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def full_worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp('epix_full'), {}, FULL_CASES,
                      torch.float32)[1]


@pytest.mark.parametrize('mesh', FULL_CASES)
def test_full_size_step_on_a_mesh_matches_one_process(full_worlds, mesh):
    check_update(*full_worlds[mesh], mesh)
