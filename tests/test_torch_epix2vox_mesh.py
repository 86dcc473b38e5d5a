"""(E)Pix2Vox on the port's device mesh, on the CPU: gloo ranks started by
``parallel.spawn_ranks`` (one intra-op thread each), their rank functions in
``torch_mesh_workers.py``, which imports no JAX.

* The batch norm over 'data' (``collectives.batch_norm``) on two ranks
  against the JAX package's ``_BatchNorm`` on a 2-device JAX mesh with the batch
  sharded on 'data' (the conftest's virtual devices): output within 1e-6 of its
  max, input, scale and bias gradients within the JAX package's own mesh bound
  (``tests/test_parallel.py:138-143``).
* One ``Bottleneck`` split over {'model': 2} and {'model': 4} against the whole one.
* One ``train_step`` of ``EPix2VoxModel128`` (binarized labels, augmentation
  on) with the decoder narrowed to a 32^3 output, (E)Pix2Vox on {'data': 2},
  {'model': 2} and {'data': 2, 'model': 2} and Pix2Vox on {'model': 4}, each
  against the port in one process, the model's parameters in float64 on both
  sides (the model computes in its parameters' dtype; the slices before it stay
  float32): its float32 results are far from exact arithmetic already in one
  process (one device's ``encoder.l4_bn.weight`` gradient strays by half of
  itself from float64), so only float64 lets a mesh's other summation orders
  be held at the JAX package's mesh bound (``tests/test_parallel.py:138-143``):
  the loss, the Dice and each gradient leaf within max(1e-5 of its max, 1e-6).
  The stage is the shipped (E)Pix2Vox configs' ``ref`` stage: fixed views, so
  the gradient reaching the model is the whole story. The updated parameters,
  Adam's moments (both param groups) and the split as for the hybrid U-Net
  (``test_torch_mesh.py``). At full size, in float32, the update and the split
  on {'data': 2} and {'model': 2}: ``test_torch_epix2vox_mesh_full.py``.
* In a process group of one, {'data': 1} and {'model': 1} are the unmeshed step
  bit for bit.

The runner and the CLI under a mesh are in ``test_torch_epix2vox_mesh_runner.py``.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec

from acquisition_focus_tpu.models.epix2vox import _BatchNorm
from acquisition_focus_tpu.parallel import mesh as jmesh
from acquisition_focus_tpu_torch.data import make_heart_phantom
from acquisition_focus_tpu_torch.models.epix2vox import Bottleneck
from acquisition_focus_tpu_torch.parallel.mesh import (
    feature_split_dims, free_port, join_ranks, spawn_ranks)

import torch_mesh_workers as workers
from test_torch_train_step import view_affines

# the shipped (E)Pix2Vox configs' ref stage (config_dict_id21.json: 2 views,
# binarized labels, fixed views) at the model's fixed 128^3, batch 2 x accum 1
FULL = dict(
    n_views=2, num_classes=2, n_active_views=2, view_optimization_mode='opt-none',
    use_affine_theta=False, use_binarized_labels=True, hires_fov_vox=(128,) * 3,
    prescan_fov_vox=(32,) * 3, locnet_width=2, num_grad_accum_steps=1,
    compute_dtype='float32', augment_input=True, model_type='hybrid-EPix2Vox')
# the decoder narrowed to four levels: a 32^3 output at 6 mm, batch 2 x accum 2
NARROW = dict(FULL, hires_fov_vox=(32,) * 3, slice_fov_vox=(32, 32, 1),
              slice_fov_mm=(192.0, 192.0, 6.0), num_grad_accum_steps=2)
NARROW_DECODER = (16, 8, 8, 8)
CASES = {   # mesh: (spec, decoder, mesh shape); the full-size ones run in
    # test_torch_epix2vox_mesh_full.py, beside this file in a worker of its own
    'data2': (FULL, None, {'data': 2}),
    'model2': (FULL, None, {'model': 2}),
    'data2_narrow': (NARROW, NARROW_DECODER, {'data': 2}),
    'model2_narrow': (NARROW, NARROW_DECODER, {'model': 2}),
    'data2_model2': (NARROW, NARROW_DECODER, {'data': 2, 'model': 2}),
    'model4': (dict(NARROW, model_type='hybrid-Pix2Vox'), NARROW_DECODER, {'model': 4}),
}
NARROW_CASES = ('data2_narrow', 'model2_narrow', 'data2_model2', 'model4')
BOTTLENECK = (16, 8, 2)      # in channels, features (x4 out), stride


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_bound(scale):
    """tests/test_parallel.py:140-141."""
    return max(1e-5 * max(scale, 1e-3), 1e-6)


def phantom_batch(spec, B=2):
    """(accum, B, ...) binarized phantom labels at the spec's hires grid, their
    NIfTI affines, and view affines off the voxel knots."""
    S, accum = spec['hires_fov_vox'][0], spec['num_grad_accum_steps']
    spacing = (192.0 / S,) * 3
    rng = np.random.default_rng(0)
    label = np.stack([make_heart_phantom((S,) * 3, seed=i, spacing=spacing)[0] > 0
                      for i in range(accum * B)]).reshape((accum, B) + (S,) * 3)
    return {'label': label.astype(np.int64),
            'nii_affine': np.broadcast_to(np.diag(list(spacing) + [1.0]),
                                          (accum, B, 4, 4)).astype(np.float32),
            'view_affines': np.stack([view_affines(rng, 2, B) for _ in range(accum)])}


def distance(a, b):
    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().max())


def jax_batch_norm(x, weight, bias, cotangent):
    """The JAX package's ``_BatchNorm`` (channels-last) on {'data': 2} of the
    conftest's virtual devices, the batch sharded on 'data': output, input
    gradient and parameter gradients of sum(y * cotangent), channels-first."""
    mesh = jmesh.make_mesh({'data': 2})
    put = lambda a: jax.device_put(jnp.asarray(np.moveaxis(a, 1, -1)),  # noqa: E731
                                   NamedSharding(mesh, PartitionSpec('data')))
    params = {'params': {'scale': jnp.asarray(weight), 'bias': jnp.asarray(bias)}}
    norm = _BatchNorm()

    @jax.jit
    def fwd_bwd(params, x, ct):
        y, vjp = jax.vjp(norm.apply, params, x)
        dparams, dx = vjp(ct)
        return y, dx, dparams['params']['scale'], dparams['params']['bias']

    y, dx, dw, db = fwd_bwd(params, put(x), put(cotangent))
    return dict(y=np.moveaxis(np.asarray(y), -1, 1), dx=np.moveaxis(np.asarray(dx), -1, 1),
                dweight=np.asarray(dw), dbias=np.asarray(db))


def bottleneck_inputs():
    torch.manual_seed(0)
    block = Bottleneck(*BOTTLENECK)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.startswith('bn'):
                p.copy_(torch.empty_like(p).uniform_(0.5, 1.5) if name.endswith('weight')
                        else 0.1 * torch.randn_like(p))
    x = torch.randn(2, BOTTLENECK[0], 9, 9)
    cotangent = torch.randn(2, 4 * BOTTLENECK[1], 5, 5)
    return block.state_dict(), x, cotangent


def run_worlds(tmp, jobs, names, dtype=torch.float64):
    """Start ``jobs`` ({ranks: [job]}) with the steps of the cases ``names`` (the
    model's parameters in ``dtype``) appended, each to the world its mesh
    fills, and take the one-process steps here meanwhile. Returns ({ranks:
    [rank 0's results]}, {name: (mesh step, one-process step)})."""
    inits = {n: workers.epix2vox_init(*CASES[n][:2]) for n in names}
    batches = {n: phantom_batch(CASES[n][0]) for n in names}
    where = {}
    for name in names:
        spec, dec, shape = CASES[name]
        ranks = math.prod(shape.values())
        jobs.setdefault(ranks, [])
        where[name] = (ranks, len(jobs[ranks]))
        jobs[ranks].append(('step', spec, batches[name], *inits[name], 0, shape, None, dec,
                            dtype))
    running = [spawn_ranks(workers.world, n, args=(js, str(tmp / f'w{n}')), threads=1,
                           join=False) for n, js in jobs.items()]
    refs = {}
    for name in names:
        spec, dec, _ = CASES[name]
        same = [n for n in refs if CASES[n][:2] == (spec, dec)]
        refs[name] = refs[same[0]] if same else dict(
            workers.step(spec, batches[name], *inits[name], 0, decoder=dec, dtype=dtype),
            unet_sd=inits[name][0])
    for context in running:
        join_ranks(context)
    out = {n: [torch.load(tmp / f'w{n}' / f'{i}.pt', weights_only=False)
               for i in range(len(js))] for n, js in jobs.items()}
    return out, {name: (out[n][i], refs[name]) for name, (n, i) in where.items()}


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """Two ranks: the batch norm on {'data': 2}, the Bottleneck on {'model': 2};
    four: the Bottleneck on {'model': 4} and the narrow steps. Here: the JAX
    batch norm, the whole Bottleneck, the one-process steps."""
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.normal(size=(4, 6, 5, 7, 3))).astype(np.float32)
    bn_args = (x, rng.uniform(0.5, 1.5, 6).astype(np.float32),
               rng.normal(0.0, 0.1, 6).astype(np.float32),
               rng.normal(size=x.shape).astype(np.float32))
    block_sd, bx, bct = bottleneck_inputs()
    ref = {'batch_norm': jax_batch_norm(*bn_args)}
    block = Bottleneck(*BOTTLENECK)
    block.load_state_dict(block_sd)
    xr = bx.clone().requires_grad_()
    y = block(xr)
    (y * bct).sum().backward()
    ref['bottleneck'] = dict(y=y.detach(), dx=xr.grad,
                             grads={n: p.grad for n, p in block.named_parameters()})
    jobs = {2: [('batch_norm', *[torch.from_numpy(a) for a in bn_args], 2),
                ('bottleneck', block_sd, BOTTLENECK, bx, bct, 2)],
            4: [('bottleneck', block_sd, BOTTLENECK, bx, bct, 4)]}
    out, steps = run_worlds(tmp_path_factory.mktemp('epix_worlds'), jobs, NARROW_CASES)
    got = {'batch_norm': out[2][0], 'bottleneck2': out[2][1], 'bottleneck4': out[4][0]}
    return got, ref, steps


def test_global_batch_norm_matches_jax_on_a_data_mesh(worlds):
    got, ref = worlds[0]['batch_norm'], worlds[1]['batch_norm']
    y, y_ref = got['y'].numpy(), ref['y']
    assert np.abs(y - y_ref).max() <= 1e-6 * np.abs(y_ref).max()
    for key in ('dx', 'dweight', 'dbias'):
        scale = float(np.abs(ref[key]).max())
        delta = float(np.abs(got[key].numpy() - ref[key]).max())
        assert delta <= jax_bound(scale), (key, delta, scale)


@pytest.mark.parametrize('m', [2, 4])
def test_sharded_bottleneck_matches_the_whole(worlds, m):
    got, ref = worlds[0][f'bottleneck{m}'], worlds[1]['bottleneck']
    block = Bottleneck(*BOTTLENECK)
    assert got['split'] == sorted(feature_split_dims(block, m))
    assert got['split'] == sorted(n for n, _ in block.named_parameters())
    for key in ('y', 'dx'):
        scale = float(ref[key].abs().max())
        assert float((got[key] - ref[key]).abs().max()) <= jax_bound(scale), key
    assert got['grads'].keys() == ref['grads'].keys()
    for name, g in ref['grads'].items():
        scale = float(g.abs().max())
        delta = float((got['grads'][name] - g).abs().max())
        assert delta <= jax_bound(scale), (name, delta, scale)


def check_values(got, ref, keys=('loss', 'dice')):
    """The mesh's ``keys`` within the JAX package's mesh bound (:func:`jax_bound`
    of the one-process value's max) of the one-process step's."""
    for key in keys:
        scale = float(ref[key].abs().max())
        assert distance(got[key], ref[key]) <= jax_bound(scale), (
            key, distance(got[key], ref[key]), scale)


def check_step(got, ref, mesh):
    """The mesh's float64 loss, Dice and every gradient leaf within the JAX
    package's mesh bound of the one-process float64 step's, and
    :func:`check_update`."""
    check_values(got, ref)
    assert got['grads'].keys() == ref['grads'].keys()
    for name, g in ref['grads'].items():
        scale = float(g.abs().max())
        dev = distance(got['grads'][name], g)
        assert dev <= jax_bound(scale), (name, dev, scale)
    check_update(got, ref, mesh)


def check_update(got, ref, mesh):
    """The updated parameters are the first Adam step (both param groups'
    rates) of the mesh's own gathered gradient, the ATMs of the fixed views are
    unchanged and bit-equal on every rank, the split is the rule's, and Adam's
    moments have the full parameters' shapes."""
    spec, decoder, _ = CASES[mesh]
    unet_sd = ref['unet_sd']
    for name, p in ref['params'].items():
        assert got['params'][name].shape == p.shape, name
        g = got['grads'].get(name)
        if g is None:
            assert torch.equal(got['params'][name], p), name
            continue
        lr = 1e-4 if name.startswith('unet.merger.') else 1e-3
        p0 = unet_sd[name[len('unet.'):]]
        want = p0 - lr * g / (g.abs() + 1e-8)
        assert distance(got['params'][name], want) <= jax_bound(float(p0.abs().max())), name
    assert got['replicas_equal']
    m = CASES[mesh][2].get('model', 1)
    _, unet, _ = workers.models(spec, decoder)
    assert got['split'] == (sorted(feature_split_dims(unet, m)) if m > 1 else [])
    if m > 1:       # the modules the rule leaves whole stay replicated
        assert not any(n.startswith(('encoder.l4_', 'decoder.head.', 'merger.m4_'))
                       for n in got['split'])
        assert any(n.startswith('merger.m3_') for n in got['split']) == (m == 2)
    assert got['moment_shapes'] == ref['moment_shapes']
    assert len(got['moment_shapes']) == sum(k.startswith('unet.') for k in ref['params'])


@pytest.mark.parametrize('mesh', NARROW_CASES)
def test_epix2vox_step_on_a_mesh_matches_one_process(worlds, mesh):
    check_step(*worlds[2][mesh], mesh)


@pytest.mark.parametrize('shape', [{'data': 1}, {'model': 1}])
def test_world_of_one_is_bit_equal(shape):
    """In a process group of one rank, the narrow (E)Pix2Vox step on {'data': 1}
    (the batch norms given their group, the gradient all-reduce) and {'model': 1}
    (every conv and norm pair its sharded stand-in) is the unmeshed step bit for
    bit (``chip_smoke.py`` holds the same of ``run_dl`` on the card)."""
    spec, dec, _ = CASES['data2_model2']
    batch, state = phantom_batch(spec), workers.epix2vox_init(spec, dec)
    ref = workers.step(spec, batch, *state, 0, decoder=dec)
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{free_port()}',
                            rank=0, world_size=1)
    try:
        got = workers.step(spec, batch, *state, 0, shape, decoder=dec)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got['loss'], ref['loss']) and torch.equal(got['dice'], ref['dice'])
    assert got['grads'].keys() == ref['grads'].keys()
    for k, v in ref['grads'].items():
        assert torch.equal(got['grads'][k], v), k
    for k, v in ref['params'].items():
        assert torch.equal(got['params'][k], v), k
    assert bool(got['split']) == ('model' in shape)
