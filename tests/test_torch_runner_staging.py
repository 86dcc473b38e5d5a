"""The runner's staging of a batch to the device (``engine/runner.py::_to_device``).

On the CPU the plain path: labels as int64, the rest float32, the image only with
``image=True``, the values of the host arrays, one ``stage.plain`` count per
array, for a contiguous macrobatch and for a 'data' shard's slice along axis 1
(non-contiguous). The ``cuda`` tests hold the pinned route on the card: no
blocking copy or stream sync once warm, the bits of a host-side cast, sources
free on return, back-to-back batches intact, ``stage.pinned_bytes`` counted:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_runner_staging.py -q

This module imports no JAX.
"""

import numpy as np
import pytest
import torch

from acquisition_focus_tpu_torch.engine.runner import _host_tensor, _to_device
from acquisition_focus_tpu_torch.parallel.mesh import Mesh, shard_batch
from acquisition_focus_tpu_torch.utils import spans

ACCUM, B, V = 2, 2, 3


def make_batch(seed, S=8):
    """A train macrobatch as the datasets store it: int32 labels, float32 image
    and affines, view affines (accum, V, B, 4, 4) transposed from (V, accum, B)."""
    rng = np.random.default_rng(seed)
    views = rng.standard_normal((V, ACCUM, B, 4, 4)).astype(np.float32)
    return {'label': rng.integers(0, 6, (ACCUM, B, S, S, S)).astype(np.int32),
            'image': rng.standard_normal((ACCUM, B, S, S, S)).astype(np.float32),
            'nii_affine': rng.standard_normal((ACCUM, B, 4, 4)).astype(np.float32),
            'view_affines': views.transpose(1, 0, 2, 3, 4)}


def data_shard(batch, index=1):
    """This rank's slice of a train batch on a {'data': 2} mesh (axis 1; the view
    affines' axis 2): views into the full arrays, none contiguous."""
    mesh = Mesh(shape={'data': 2}, device_mesh=None, coords={'data': index}, groups={},
                device=torch.device('cpu'))
    return shard_batch(batch, mesh, train=True)


KINDS = ('contiguous', 'data_shard')


def batch_of(kind, seed, S=8):
    """(the full macrobatch, what is staged of it: the whole or a shard)."""
    full = make_batch(seed, S)
    return full, data_shard(full) if kind == 'data_shard' else full


def expected(batch, image, device):
    """What the staging gave before the pinned route: a cast on the host and one
    ``torch.as_tensor`` per array."""
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64 if k == 'label'
                               else torch.float32, device=device)
            for k, v in batch.items() if image or k != 'image'}


def counts():
    t = spans.totals()
    return t.get('stage.plain', 0), t.get('stage.pinned_bytes', 0)


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize('image', [False, True])
@pytest.mark.parametrize('kind', KINDS)
def test_the_cpu_stages_int64_labels_and_float32_arrays(kind, image):
    _, batch = batch_of(kind, 0)
    if kind == 'data_shard':
        assert not any(v.flags.c_contiguous for v in batch.values())
    plain0, pinned0 = counts()
    out = _to_device(batch, 'cpu', image=image)
    plain1, pinned1 = counts()
    want = expected(batch, image, 'cpu')
    assert set(out) == set(want) == ({'label', 'nii_affine', 'view_affines'}
                                     | ({'image'} if image else set()))
    for k, t in out.items():
        assert t.device.type == 'cpu'
        assert t.dtype == (torch.int64 if k == 'label' else torch.float32)
        assert t.shape == batch[k].shape
        assert torch.equal(t, want[k])
    assert plain1 - plain0 == len(want)
    assert pinned1 == pinned0


def test_the_cpu_casts_float64_affines_as_the_host_does():
    batch = make_batch(1)
    batch['nii_affine'] = np.random.default_rng(2).standard_normal((ACCUM, B, 4, 4))
    out = _to_device(batch, torch.device('cpu'))
    assert out['nii_affine'].dtype == torch.float32
    assert torch.equal(out['nii_affine'],
                       torch.from_numpy(batch['nii_affine'].astype(np.float32)))


def test_a_host_tensor_keeps_the_strides_numpy_gives_it():
    shard = data_shard(make_batch(3))['label']
    t = _host_tensor(shard)
    assert t.data_ptr() == shard.ctypes.data            # a view, no copy
    assert t.stride() == tuple(s // shard.itemsize for s in shard.strides)
    flipped = make_batch(3)['label'][:, :, ::-1]        # strides torch cannot take
    t = _host_tensor(flipped)
    assert t.is_contiguous() and np.array_equal(t.numpy(), flipped)


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device('cuda')


def staged_bytes(batch, image):
    return sum(np.asarray(v).nbytes for k, v in batch.items() if image or k != 'image')


@pytest.mark.cuda
@pytest.mark.parametrize('image', [False, True])
@pytest.mark.parametrize('kind', KINDS)
def test_the_card_stages_without_a_sync_and_with_todays_bits(card, kind, image):
    _to_device(batch_of(kind, 10, S=64)[1], card, image=image)   # warm: pinned blocks
    torch.cuda.synchronize()
    full, batch = batch_of(kind, 11, S=64)
    want = expected(batch, image, card)
    torch.cuda.synchronize()
    plain0, pinned0 = counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = _to_device(batch, card, image=image)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    plain1, pinned1 = counts()
    for v in full.values():                 # the caller's arrays are free on return
        v[...] = -1
    torch.cuda.synchronize()
    assert set(out) == set(want)
    for k, t in out.items():
        assert t.device.type == 'cuda' and t.dtype == want[k].dtype
        assert torch.equal(t, want[k]), k
    assert plain1 == plain0
    assert pinned1 - pinned0 == staged_bytes(batch, image)


@pytest.mark.cuda
def test_back_to_back_batches_arrive_intact(card):
    _to_device(make_batch(20, S=64), card)
    torch.cuda.synchronize()
    batches = [make_batch(seed, S=64) for seed in (21, 22, 23)]
    wants = [expected(b, False, card) for b in batches]
    torch.cuda.synchronize()
    outs = []
    for b in batches:                       # no sync between: each block in flight
        outs.append(_to_device(b, card))
        for v in b.values():
            v[...] = 0
    torch.cuda.synchronize()
    assert not torch.equal(wants[0]['label'], wants[1]['label'])
    for out, want in zip(outs, wants):
        for k in want:
            assert torch.equal(out[k], want[k]), k


@pytest.mark.cuda
def test_the_card_casts_float64_affines_with_the_hosts_bits(card):
    batch = make_batch(30, S=64)
    batch['nii_affine'] = np.random.default_rng(31).standard_normal((ACCUM, B, 4, 4))
    _to_device(batch, card)
    want = expected(batch, False, card)
    torch.cuda.synchronize()
    out = _to_device(batch, card)
    torch.cuda.synchronize()
    assert out['nii_affine'].dtype == torch.float32
    assert torch.equal(out['nii_affine'], want['nii_affine'])
