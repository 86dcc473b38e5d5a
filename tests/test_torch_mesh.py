"""The port's device mesh (``acquisition_focus_tpu_torch/parallel``) on the CPU:
gloo ranks started by ``parallel.spawn_ranks`` (one intra-op thread each), their
rank functions in ``torch_mesh_workers.py``, which imports no JAX.

* One float32 ``train_step`` at three U-Net levels on {'data': 2}, {'model': 2},
  {'data': 2, 'model': 2} and {'model': 4} against the port in one process:
  augmentation on (its draws must be the whole batch's), a frozen and an
  inactive view, a stage the 'model' axis does not divide at m = 4, and the
  replicated 6-class head at m = 4. Gathered gradients and updated parameters
  within the JAX package's own bound (``tests/test_parallel.py``).
* The port's {'data': 2, 'model': 2} gradients against the JAX package's on the
  same mesh, from converted flax params (one JAX compile), at
  ``test_torch_train_step.py``'s tolerance.
* ``run_dl`` under {'data': 2} at 16^3 against ``run_dl`` in one process, and
  checkpoints resumed both ways; the CLI on a mesh with ``--device cpu``; a mesh
  larger than the process group. (E)Pix2Vox on a mesh:
  ``test_torch_epix2vox_mesh*.py``.
"""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu.parallel import mesh as jmesh
from acquisition_focus_tpu_torch import main as tmain
from acquisition_focus_tpu_torch.convert import atm_state_dicts, unet_state_dict
from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
from acquisition_focus_tpu_torch.data.phantom import phantom_cases
from acquisition_focus_tpu_torch.data.synthetic import write_phantom_dataset
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.checkpoint import load_checkpoint
from acquisition_focus_tpu_torch.engine.config import DEFAULTS, load_config
from acquisition_focus_tpu_torch.engine.runner import run_dl
from acquisition_focus_tpu_torch.parallel.mesh import (
    feature_split_dims, free_port, join_ranks, spawn_ranks)

import torch_mesh_workers as workers
from test_torch_train_step import SKINNY, is_pre_norm_bias, make_batch, view_affines

# three U-Net levels, 3 views (the grouped encoder convs' slices cut groups), 6
# classes (the head splits at m = 2, stays replicated at m = 4), level 0's 6
# features not divisible by 4; view 0 frozen, view 2 inactive
PORT_SPEC = dict(
    n_views=3, num_classes=6, n_active_views=2,
    view_optimization_mode='opt-current-fix-previous', use_affine_theta=True,
    hires_fov_mm=(24.0,) * 3, hires_fov_vox=(16,) * 3, slice_fov_mm=(24.0, 24.0, 1.5),
    slice_fov_vox=(16, 16, 1), prescan_fov_mm=(24.0,) * 3, prescan_fov_vox=(32,) * 3,
    num_grad_accum_steps=2, compute_dtype='float32', augment_input=True,
    augment_recon=True, base_features=(2, 4, 8), locnet_width=2)
MESHES = {'data2': {'data': 2}, 'model2': {'model': 2},
          'data2_model2': {'data': 2, 'model': 2}, 'model4': {'model': 4}}
KINK_FREE_SEEDS = (4, 7)     # test_torch_train_step.py: batches with no sample near a kink
# The step's gradient jumps where a LeakyReLU input changes sign; a mesh computes
# each input with another float32 summation order than one process, so an input
# within that rounding of 0 takes the other slope there and moves the gradients
# behind it by ~1e-3 of their max (the batch below has 4 such elements on
# {'model': 2}). The mesh runs with the one-process slopes imposed (each rank its
# rows and feature slice; ``smoke_mesh.Branches``), as test_torch_step_kinks.py
# aligns the JAX package's: the inputs must agree within ACT_AGREE and only a
# handful of slopes may differ (each counted twice: forward and recompute).
ACT_AGREE = 1e-4
MAX_SLOPE_FLIPS = 10


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def port_batch(B=4):
    rng = np.random.default_rng(0)
    S, accum = 16, PORT_SPEC['num_grad_accum_steps']
    return {'label': rng.integers(0, 6, (accum, B, S, S, S)).astype(np.int64),
            'nii_affine': np.broadcast_to(np.diag([1.5, 1.5, 1.5, 1.0]),
                                          (accum, B, 4, 4)).astype(np.float32),
            'view_affines': np.stack([view_affines(rng, 3, B) for _ in range(accum)])}


def jax_moments(unet_params):
    """Adam moments of every U-Net parameter, by port name, in the orbax import's
    form (``engine/orbax_import.py``): seeded draws at the parameters' shapes."""
    rng = np.random.default_rng(3)
    return {k: {'step': torch.tensor(3.0),
                'exp_avg': torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)),
                'exp_avg_sq': torch.from_numpy(rng.random(v.shape).astype(np.float32))}
            for k, v in unet_state_dict(unet_params).items()}


def port_init():
    unet, atms = ttrain.make_models(ttrain.StageSpec(**PORT_SPEC), 'cpu')
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(0))
    return unet.state_dict(), [m.state_dict() for m in atms]


def jax_skinny_batch():
    """Two kink-free one-sample batches side by side: per-sample instance norms
    keep each sample's activations its own."""
    spec = jtrain.StageSpec(**SKINNY)
    parts = [make_batch(spec, np.random.default_rng(s)) for s in KINK_FREE_SEEDS]
    return {k: np.concatenate([p[k] for p in parts], axis=2 if k == 'view_affines' else 1)
            for k in parts[0]}


def jax_mesh_grads(batch, params):
    """The JAX package's train_step gradients (mean over the microbatches) on
    {'data': 2, 'model': 2} of the conftest's virtual devices, from ``params``."""
    spec = jtrain.StageSpec(**SKINNY)
    unet, atms = jtrain.make_models(spec)
    mesh = jmesh.make_mesh({'data': 2, 'model': 2})
    up, ap = jmesh.shard_params(*jax.tree_util.tree_map(jnp.asarray, params), mesh)

    def loss_fn(params, micro):
        return jtrain.forward(spec, unet, params[0], atms, params[1], micro, None,
                              train=True)[0]

    grad_fn = jax.jit(jax.grad(loss_fn))
    accum = spec.num_grad_accum_steps
    grads = [grad_fn((up, ap), jmesh.shard_batch(
        {k: jnp.asarray(v[i]) for k, v in batch.items()}, mesh, train=False))
        for i in range(accum)]
    return jax.tree_util.tree_map(lambda *g: sum(np.asarray(x) for x in g) / accum, *grads)


# ---------------------------------------------------------------- the runner's setup

RUN = dict(
    base_views=['p2CH', 'p2CH'], view_optimization_mode='opt-all', use_affine_theta=True,
    hires_fov_mm=[24.0] * 3, hires_fov_vox=[16] * 3, slice_fov_mm=[24.0, 24.0, 1.5],
    slice_fov_vox=[16, 16, 1], prescan_fov_mm=[24.0] * 3, prescan_fov_vox=[32] * 3,
    compute_dtype='float32', base_features=[2, 4, 4, 8], locnet_width=2, batch_size=2,
    num_grad_accum_steps=1, val_batch_size=2, metrics_every=1000, do_output=False,
    save_every=1, use_caching=False, epochs=2)
FOLD = (0, ([0, 1, 2, 3], [4, 5]))
# the CLI runs' meta config (without its paths): 32^3 phantoms, fold 0, one epoch
CLI_META = dict(
    fold_override=0, use_caching=False, epochs=1, hires_fov_mm=[48.0] * 3,
    hires_fov_vox=[32] * 3, prescan_fov_mm=[48.0] * 3, prescan_fov_vox=[32] * 3,
    slice_fov_mm=[48.0, 48.0, 1.5], slice_fov_vox=[32, 32, 1],
    base_features=[2, 4, 4, 8], locnet_width=2, batch_size=2, num_grad_accum_steps=1,
    compute_dtype='float32', base_views=['p2CH', 'p4CH'], num_sa_slices=3,
    do_output=False, mesh_shape={'data': 2})


def run_config(tmp, **overrides):
    return load_config(overrides=dict(RUN, log_dir=str(tmp / 'runs'),
                                      mdl_save_prefix=str(tmp / 'models'), **overrides))


def loss_track(tmp, name):
    track = {}
    for line in (tmp / 'runs' / name / 'metrics.jsonl').read_text().splitlines():
        rec = json.loads(line)
        for k in ('losses/train_loss', 'losses/val_loss', 'losses/test_loss'):
            if k in rec:
                track[(rec['step'], k)] = rec[k]
    return track


@pytest.fixture(scope='module')
def worlds(tmp_path_factory, one_process):
    """Two worlds of gloo ranks, run side by side with this process's work. Two
    ranks: the step on {'data': 2} and {'model': 2}; run_dl under {'data': 2},
    afresh and resumed from this process's checkpoint; a mesh of four in a world
    of two. Four ranks: the step on {'data': 2, 'model': 2} and {'model': 4}, and
    the JAX comparison's step on {'data': 2, 'model': 2}. Meanwhile, here: the
    JAX package's mesh gradients (in a thread) and the one-process runs."""
    tmp = tmp_path_factory.mktemp('worlds')
    cfg = load_config(overrides=RUN)
    datasets = (BaseDataset.from_cases(phantom_cases(6, (16,) * 3, (1.5,) * 3, 2), cfg),
                BaseDataset.from_cases(phantom_cases(1, (16,) * 3, (1.5,) * 3, 2, 100),
                                       cfg, 'test'))
    mesh_cfg = run_config(tmp, mesh_shape={'data': 2})
    unet_sd, atm_sds = port_init()
    batch, ref = port_batch(), one_process['branches']
    single_ckpt = tmp / 'models' / 'single_epx0'
    write_phantom_dataset(tmp / 'data', n_cases=6, shape=(32,) * 3)
    (tmp / 'join.json').write_text(json.dumps(dict(
        CLI_META, dataset=['synthetic', str(tmp / 'data')], sweep_type=None,
        log_dir=str(tmp / 'join_runs'), mdl_save_prefix=str(tmp / 'join_models'))))
    jobs = {2: [('step', PORT_SPEC, batch, unet_sd, atm_sds, 0, MESHES['data2'], ref),
                ('step', PORT_SPEC, batch, unet_sd, atm_sds, 0, MESHES['model2'], ref),
                ('run', str(tmp), mesh_cfg, FOLD, datasets, 'mesh'),
                ('wait_for', str(single_ckpt)),
                ('run', str(tmp), dict(mesh_cfg, model_checkpoint_path=str(single_ckpt)),
                 FOLD, datasets, 'mesh_resumed'),
                ('mesh_error', {'data': 4}),
                ('cli', ['--meta_config_path', str(tmp / 'join.json'), '--base_dir',
                         str(tmp)]),
                ('replayed_gather_on', MESHES['model2'])]}
    running = [spawn_ranks(workers.world, 2, args=(jobs[2], str(tmp / 'w2')), threads=1,
                           join=False)]
    jbatch = jax_skinny_batch()
    up, ap = jax.tree_util.tree_map(
        np.array, jtrain.init_params(jtrain.StageSpec(**SKINNY), jax.random.key(0)))
    jobs[4] = [('step', PORT_SPEC, batch, unet_sd, atm_sds, 0, MESHES['data2_model2'], ref),
               ('step', PORT_SPEC, batch, unet_sd, atm_sds, 0, MESHES['model4'], ref),
               ('step', SKINNY, jbatch, unet_state_dict(up), atm_state_dicts(ap), None,
                {'data': 2, 'model': 2}),
               ('weights_across', SKINNY, up, ap, jax_moments(up), {'data': 2, 'model': 2})]
    running.append(spawn_ranks(workers.world, 4, args=(jobs[4], str(tmp / 'w4')),
                               threads=1, join=False))
    jgrads = {}
    jax_thread = threading.Thread(
        target=lambda: jgrads.update(grads=jax_mesh_grads(jbatch, (up, ap))))
    jax_thread.start()
    workers.run(str(tmp), run_config(tmp), FOLD, datasets, 'single')
    for context in running:
        join_ranks(context)
    workers.run(str(tmp), run_config(tmp, model_checkpoint_path=str(
        tmp / 'models' / 'mesh_epx0')), FOLD, datasets, 'single_resumed')
    jax_thread.join()
    out = {n: [torch.load(tmp / f'w{n}' / f'{i}.pt', weights_only=False)
               for i in range(len(js))] for n, js in jobs.items()}
    return dict(tmp=tmp, steps={'data2': out[2][0], 'model2': out[2][1],
                                'data2_model2': out[4][0], 'model4': out[4][1]},
                mesh_error=out[2][5], replayed_gather=out[2][7], jax_mesh=out[4][2],
                jax_grads=jgrads['grads'],
                weights=out[4][3], jax_params=up, moments=jax_moments(up))


@pytest.fixture(scope='module')
def one_process():
    """The port's step in this process: the reference of every mesh."""
    unet_sd, atm_sds = port_init()
    return workers.step(PORT_SPEC, port_batch(), unet_sd, atm_sds, 0)


def jax_bound(scale):
    """tests/test_parallel.py:140-141."""
    return max(1e-5 * max(scale, 1e-3), 1e-6)


@pytest.mark.parametrize('mesh', list(MESHES))
def test_mesh_step_matches_one_process(mesh, worlds, one_process):
    got = worlds['steps'][mesh]
    ref = one_process
    assert got['branch_flips'] <= MAX_SLOPE_FLIPS and got['act_max_diff'] <= ACT_AGREE, (
        got['branch_flips'], got['act_max_diff'])
    np.testing.assert_allclose(float(got['loss']), float(ref['loss']), rtol=1e-5)
    np.testing.assert_allclose(got['dice'].numpy(), ref['dice'].numpy(), atol=1e-6)
    assert got['grads'].keys() == ref['grads'].keys()
    assert not any(k.startswith('atms.0.') or k.startswith('atms.2.') for k in got['grads'])
    for name, g in ref['grads'].items():
        scale = float(g.abs().max())
        delta = float((got['grads'][name] - g).abs().max())
        assert delta <= jax_bound(scale), (name, delta, scale)
    n_checked = 0
    for name, p in ref['params'].items():
        assert got['params'][name].shape == p.shape, name
        g = ref['grads'].get(name)
        if g is None:       # frozen and inactive views: no update at all
            assert torch.equal(got['params'][name], p), name
            continue
        if is_pre_norm_bias(name):      # an exact zero gradient: Adam steps on noise
            continue
        sel = g.abs() > 1e-3 * g.abs().max()
        delta = float((got['params'][name] - p)[sel].abs().max()) if sel.any() else 0.0
        assert delta <= jax_bound(float(p.abs().max())), (name, delta)
        n_checked += int(sel.sum())
    assert n_checked > 0
    assert got['replicas_equal']
    m = MESHES[mesh].get('model', 1)
    unet, _ = ttrain.make_models(ttrain.StageSpec(**PORT_SPEC), 'cpu')
    assert got['split'] == (sorted(feature_split_dims(unet, m)) if m > 1 else [])
    if m == 4:      # level 0 (6 features) and the 6-class head stay replicated
        assert not any(n.startswith(('encoder.0.', 'decoder.0.', 'seg_head.'))
                       for n in got['split'])
        assert any(n.startswith('encoder.1.') for n in got['split'])
    assert got['moment_shapes'] == ref['moment_shapes']


def test_mesh_grads_match_jax_mesh(worlds):
    """The port's {'data': 2, 'model': 2} step gradients against the JAX package's
    on the same mesh: atol 1e-4 after dividing each leaf by its max; the pre-norm
    conv biases (exactly zero) within 1e-5 of the largest leaf's max."""
    got = worlds['jax_mesh']['grads']
    ref = {f'unet.{k}': v.numpy()
           for k, v in unet_state_dict(worlds['jax_grads'][0]).items()}
    for v, sd in enumerate(atm_state_dicts(worlds['jax_grads'][1])):
        ref.update({f'atms.{v}.{k}': t.numpy() for k, t in sd.items()})
    assert got.keys() == ref.keys()
    assert worlds['jax_mesh']['split']
    top = max(float(np.abs(r).max()) for r in ref.values())
    for name, r in ref.items():
        g = got[name].numpy()
        if is_pre_norm_bias(name):
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-5 * top, name
            continue
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g / scale, r / scale, atol=1e-4, err_msg=name)


def test_weights_load_straight_into_a_split_model(worlds):
    """``convert.load_flax_params_sharded`` and ``load_optimizer`` with a split:
    the JAX package's full params and the orbax import's full moments, loaded
    into a {'data': 2, 'model': 2} model, gather back to themselves bit for bit."""
    got = worlds['weights']
    assert got['split']
    want = unet_state_dict(worlds['jax_params'])
    assert got['params'].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got['params'][k], v), k
    moments = worlds['moments']
    for i, name in enumerate(got['names']):
        for key in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(got['opt']['state'][i][key], moments[name][key]), (name, key)


def test_run_dl_data_parallel_matches_one_process(worlds):
    """Loss tracks within the JAX package's 2e-3 (first train loss 1e-3), and a
    checkpoint resumed in the other setting follows the uninterrupted run."""
    tmp = worlds['tmp']
    single, mesh = loss_track(tmp, 'single'), loss_track(tmp, 'mesh')
    assert single.keys() == mesh.keys() and len(single) == 6
    first = min(single)
    assert abs(single[first] - mesh[first]) < 1e-3
    for key, v in single.items():
        assert abs(v - mesh[key]) < 2e-3, (key, v, mesh[key])
    last = max(s for s, _ in single)
    for resumed, ref in (('mesh_resumed', single), ('single_resumed', mesh)):
        track = loss_track(tmp, resumed)
        assert {s for s, _ in track} == {last}, resumed
        for key, v in track.items():
            assert abs(v - ref[key]) < 2e-3, (resumed, key, v, ref[key])


def test_mesh_checkpoints_are_one_device_files(worlds):
    """Rank 0 alone writes each checkpoint, in the one-device format: every
    tensor at its full shape."""
    tmp = worlds['tmp']
    files = sorted(p.name for p in (tmp / 'models').iterdir())
    assert files == sorted([f'{r}_epx{e}' for r in ('single', 'mesh') for e in (0, 1)] +
                           ['mesh_resumed_epx1', 'single_resumed_epx1'])
    a, b = (load_checkpoint(tmp / 'models' / f'{r}_epx1') for r in ('single', 'mesh'))
    for key in ('unet', 'atms'):
        assert {k: v.shape for k, v in a[key].items()} == \
            {k: v.shape for k, v in b[key].items()}
    assert {i: s['exp_avg'].shape for i, s in a['recon_opt']['state'].items()} == \
        {i: s['exp_avg'].shape for i, s in b['recon_opt']['state'].items()}
    lines = (tmp / 'runs' / 'mesh' / 'metrics.jsonl').read_text().splitlines()
    assert len(lines) == len((tmp / 'runs' / 'single' / 'metrics.jsonl')
                             .read_text().splitlines())


@pytest.mark.parametrize('shape', [{'data': 1}, {'model': 1}])
def test_world_of_one_is_bit_equal(shape, one_process):
    """In a process group of one rank, the step on {'data': 1} (the gradient
    all-reduce) and {'model': 1} (every U-Net module swapped for its sharded
    stand-in, every collective at world size 1) is the unmeshed step bit for bit:
    the plumbing adds nothing (``chip_smoke.py`` holds the same on the card)."""
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{free_port()}',
                            rank=0, world_size=1)
    try:
        unet_sd, atm_sds = port_init()
        got = workers.step(PORT_SPEC, port_batch(), unet_sd, atm_sds, 0, shape)
    finally:
        dist.destroy_process_group()
    ref = one_process
    assert torch.equal(got['loss'], ref['loss']) and torch.equal(got['dice'], ref['dice'])
    assert got['grads'].keys() == ref['grads'].keys()
    for k, v in ref['grads'].items():
        assert torch.equal(got['grads'][k], v), k
    for k, v in ref['params'].items():
        assert torch.equal(got['params'][k], v), k
    n_unet = sum(k.startswith('unet.') for k in ref['params'])
    assert len(got['split']) == (n_unet if 'model' in shape else 0)


def test_a_replayed_gather_sends_nothing(worlds):
    """On {'model': 2}, a recompute region that keeps its all-gather (as the
    feature-sharded decoder stages do) gathers once, in the forward, which
    ``collective.calls`` counts; its replay in backward takes the kept output,
    so no collective runs there and the counters do not move."""
    kept = worlds['replayed_gather']
    fwd, bwd = kept['after_forward'], kept['after_backward']
    assert fwd['collective.calls'] >= 1
    assert (bwd['collective.calls'], bwd['collective.bytes']) == \
        (fwd['collective.calls'], fwd['collective.bytes'])
    assert not any('_c10d' in op for op in kept['backward_ops'])
    assert bwd['recompute.served'] == 1 and kept['grad_ok']


def test_mesh_larger_than_the_processes_raises(worlds):
    assert 'needs 4 processes' in worlds['mesh_error']
    with pytest.raises(RuntimeError, match='no process group'):
        run_dl('.', dict(DEFAULTS, mesh_shape={'data': 2}), (0, ([], [])), device='cpu')


def test_cli_joins_an_existing_process_group(worlds):
    """``main()`` in each rank of a process group that exists (as under torchrun):
    rank 0 builds the datasets and sends them; one run_dl on {'data': 2}; rank 0
    alone writes the run's metrics and checkpoint."""
    tmp = worlds['tmp']
    runs = list((tmp / 'join_runs').iterdir())
    assert len(runs) == 1
    lines = (runs[0] / 'metrics.jsonl').read_text().splitlines()
    losses = [v for r in map(json.loads, lines) for k, v in r.items()
              if k.startswith('losses/')]
    assert losses and np.isfinite(losses).all()
    assert [p.name for p in (tmp / 'join_models').iterdir()] == [f'{runs[0].name}_best']


def test_cli_runs_a_mesh_sweep_on_the_cpu(tmp_path):
    """``main([...], device='cpu')`` with ``mesh_shape`` {'data': 2}: the CLI builds
    the datasets once and starts two gloo ranks; the sweep completes its stages
    (rank 0 writes the sweep state and metrics) and every checkpoint loads into a
    one-process model."""
    write_phantom_dataset(tmp_path / 'data', n_cases=6, shape=(32,) * 3)
    meta = dict(
        CLI_META, dataset=['synthetic', str(tmp_path / 'data')],
        sweep_state_path=str(tmp_path / 'sweep_state.json'),
        log_dir=str(tmp_path / 'runs'), mdl_save_prefix=str(tmp_path / 'models'))
    (tmp_path / 'meta.json').write_text(json.dumps(meta))
    tmain.main(['--meta_config_path', str(tmp_path / 'meta.json'),
                '--base_dir', str(tmp_path)], device='cpu')

    state = json.loads((tmp_path / 'sweep_state.json').read_text())
    assert list(state['completed']) == ['fold-0/opt_view0', 'fold-0/opt_view1',
                                        'fold-0/ref']
    spec = ttrain.StageSpec(n_views=2, num_classes=6, n_active_views=2,
                            view_optimization_mode='opt-all', use_affine_theta=True,
                            hires_fov_vox=(32,) * 3, prescan_fov_vox=(32,) * 3,
                            base_features=(2, 4, 4, 8), locnet_width=2)
    unet, atms = ttrain.make_models(spec, 'cpu')
    for rec in state['completed'].values():
        ck = load_checkpoint(rec['save_path'])
        unet.load_state_dict(ck['unet'])
        atms.load_state_dict(ck['atms'])
        lines = (Path(tmp_path) / 'runs' / rec['run_name'] / 'metrics.jsonl') \
            .read_text().splitlines()
        assert len({line for line in lines}) == len(lines)
        losses = [v for r in map(json.loads, lines) for k, v in r.items()
                  if k.startswith('losses/')]
        assert losses and np.isfinite(losses).all()
