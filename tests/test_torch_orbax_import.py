"""The import of the JAX package's orbax checkpoints (``engine/orbax_import.py``,
``scripts/import_orbax.py``), on the CPU. Every checkpoint here is written by the
JAX package's own ``save_checkpoint`` (one zarr3 case by orbax directly, which
the JAX package never writes) and read back without JAX: the tree, the params
through ``convert.py``, both optimizers' moments and counts, a run that resumes
in the port's ``run_dl`` from a JAX pause, and a segmenter. The card's machine
may lack ``tensorstore``, so ``tests/torch_data/orbax_run.*`` carries one import
there (``chip_smoke.py``); a case here writes it again and holds the committed
files to it.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from acquisition_focus_tpu.engine import optimizers as jopt
from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu.engine.checkpoint import load_checkpoint as jload_checkpoint
from acquisition_focus_tpu.engine.checkpoint import save_checkpoint as jsave
from acquisition_focus_tpu.engine.config import load_config as jload_config
from acquisition_focus_tpu.engine.runner import run_dl as jrun_dl
from acquisition_focus_tpu.engine.runner import spec_from_config as jspec_from_config
from acquisition_focus_tpu.models.segmentation.unet2d import SegUnet2D as JSegUnet2D
from acquisition_focus_tpu_torch.convert import (
    atm_state_dicts, epix2vox_state_dict, segunet_state_dict, unet_state_dict)
from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
from acquisition_focus_tpu_torch.data.phantom import phantom_cases
from acquisition_focus_tpu_torch.engine import checkpoint as tck
from acquisition_focus_tpu_torch.engine import orbax_import
from acquisition_focus_tpu_torch.engine import runner as trunner
from acquisition_focus_tpu_torch.engine import segmenter as tseg
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.optimizers import (
    make_reconstruction_optimizer, make_transform_optimizer)
from test_torch_runner import RUN, run_config
from test_torch_train_step import (
    EPOCHS, LR, SKINNY, UPE, BATCH_SEED, is_pre_norm_bias, make_batch, to_np,
    torch_batch)


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Many small torch ops: with several test workers on one machine, torch's
    default of one intra-op thread per core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def run_state(up, ap, r_state, t_state, epoch=0, loss=0.5, best_quality=0.25):
    """The JAX runner's checkpoint state (``engine/runner.py:307-313``)."""
    return dict(unet_params=up, atm_params=ap,
                recon_opt_leaves=jax.tree_util.tree_leaves(r_state),
                trans_opt_leaves=jax.tree_util.tree_leaves(t_state),
                epoch=epoch, loss=loss, best_quality=best_quality)


def atms_state_dict(tree):
    """StackedATMs params -> the port's ``nn.ModuleList`` state_dict."""
    return {f'{v}.{k}': t for v, sd in enumerate(atm_state_dicts(tree)) for k, t in sd.items()}


def assert_state_dicts_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k


# ---------------------------------------------------------------- the tree

DTYPES = ['float32', 'float64', 'float16', 'bfloat16', 'int8', 'int32', 'int64',
          'uint8', 'uint32', 'bool']


@pytest.mark.parametrize('zarr3', [False, True])
def test_tree_reader(tmp_path, zarr3):
    """Nested dicts and lists, Python and numpy scalars, strings, empty
    containers, and arrays of each dtype (numpy and jax arrays) read back as
    written."""
    rng = np.random.default_rng(0)
    # every other dtype as a jax array (64-bit ones only as numpy: jax has x64 off)
    arrays = {d: jnp.asarray(rng.normal(size=(2, 3)) * 10).astype(d)
              if i % 2 and '64' not in d
              else (rng.normal(size=(2, 3)) * 10).astype(jnp.dtype(d))
              for i, d in enumerate(DTYPES)}
    tree = {'arrays': arrays, 'nested': {'list': [np.int32(3), 'text', 2.5, [True, 7]],
                                        'name.with.dots': 'x'},
            'epoch': 4, 'loss': 0.125, 'best': float('inf'), 'flag': False,
            'empty_dict': {}, 'empty_list': [], 'none': None}
    if zarr3:
        import orbax.checkpoint as ocp
        with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)) as c:
            c.save(tmp_path / 'ck', tree)
    else:
        jsave(tmp_path / 'ck', tree)
    got = orbax_import.read_tree(tmp_path / 'ck')
    assert sorted(got) == sorted(tree)
    for d, a in arrays.items():
        ref = np.asarray(a)
        assert got['arrays'][d].dtype == ref.dtype and got['arrays'][d].shape == (2, 3), d
        np.testing.assert_array_equal(got['arrays'][d], ref, err_msg=d)
    assert got['nested'] == {'list': [3, 'text', 2.5, [True, 7]], 'name.with.dots': 'x'}
    assert (got['epoch'], got['loss'], got['best'], got['flag']) == (4, 0.125, float('inf'),
                                                                    False)
    assert got['empty_dict'] == {} and got['empty_list'] == [] and got['none'] is None


def test_missing_tensorstore_raises_naming_it_and_the_cli(tmp_path, monkeypatch):
    jsave(tmp_path / 'ck', {'a': np.zeros(2, np.float32)})
    monkeypatch.setitem(sys.modules, 'tensorstore', None)
    with pytest.raises(ImportError, match='tensorstore.*scripts.import_orbax'):
        orbax_import.read_tree(tmp_path / 'ck')


def test_checkpoint_exists_on_directories(tmp_path):
    """An orbax directory is a checkpoint, an empty directory is none, and any
    other directory raises rather than letting a run start afresh beside it."""
    jsave(tmp_path / 'ck', {'a': np.zeros(2, np.float32)})
    (tmp_path / 'empty').mkdir()
    (tmp_path / 'other').mkdir()
    (tmp_path / 'other' / 'file.txt').write_text('x')
    assert tck.checkpoint_exists(tmp_path / 'ck')
    assert not tck.checkpoint_exists(tmp_path / 'empty')
    assert not tck.checkpoint_exists(tmp_path / 'missing.pt')
    with pytest.raises(ValueError, match='no orbax checkpoint'):
        tck.checkpoint_exists(tmp_path / 'other')


# ---------------------------------------------------------------- run checkpoints

# three U-Net levels keep the JAX compiles short
SPEC = dict(SKINNY, base_features=(2, 4, 4))


@pytest.fixture(scope='module')
def one_jax_step():
    """The skinny step's state after one JAX train_step (params and both optax
    states), the batch, and the JAX state after a second step from it."""
    spec_j = jtrain.StageSpec(**SPEC)
    batch = make_batch(spec_j, np.random.default_rng(BATCH_SEED))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    unet_j, atms_j = jtrain.make_models(spec_j)
    up, ap = jtrain.init_params(spec_j, jax.random.key(0))
    r_opt = jopt.make_reconstruction_optimizer(LR, UPE)
    t_opt = jopt.make_transform_optimizer(LR, EPOCHS, UPE)
    states = [(up, ap, r_opt.init(up), t_opt.init(ap))]
    for _ in range(2):
        up, ap, rs, ts, _, _ = jtrain.train_step(spec_j, unet_j, atms_j, r_opt, t_opt,
                                                 *states[-1], jb, jax.random.key(0))
        states.append(to_np((up, ap, rs, ts)))
    return dict(batch=batch, step1=states[1], step2=states[2])


def test_run_import_equals_convert(tmp_path, one_jax_step):
    """Params through ``convert.py`` as from the in-memory tree; Adam's mu and nu
    through the same layout maps as their params, optax's count as ``step``, the
    schedule's count as the scheduler's position; epoch, loss, best quality."""
    up, ap, rs, ts = one_jax_step['step1']
    jsave(tmp_path / 'run', run_state(up, ap, rs, ts, epoch=3))
    ck = tck.load_checkpoint(tmp_path / 'run')
    assert_state_dicts_equal(ck['unet'], unet_state_dict(up))
    assert_state_dicts_equal(ck['atms'], atms_state_dict(ap))
    assert (ck['epoch'], ck['loss'], ck['best_quality']) == (3, 0.5, 0.25)
    for name, state, to_sd in (('recon', rs, unet_state_dict), ('trans', ts, atms_state_dict)):
        adam, sched = state[0], state[2]
        moments = ck[f'{name}_opt']['moments']
        assert_state_dicts_equal({n: m['exp_avg'] for n, m in moments.items()},
                                 to_sd(adam.mu))
        assert_state_dicts_equal({n: m['exp_avg_sq'] for n, m in moments.items()},
                                 to_sd(adam.nu))
        assert {float(m['step']) for m in moments.values()} == {float(adam.count)} == {1.0}
        assert ck[f'{name}_sched'] == {'last_epoch': int(sched.count)}


def test_resumed_step_matches_jax_next_step(tmp_path, one_jax_step):
    """The port's first step from the imported state after one JAX step (params
    and both optimizer states) against JAX's second step: the updated params
    within the train step's tolerance (atol 1e-5 wherever |grad| > 1e-3 of the
    leaf's max), Adam's moments and the schedules carried on."""
    up, ap, rs, ts = one_jax_step['step1']
    up2, ap2, _, _ = one_jax_step['step2']
    jsave(tmp_path / 'run', run_state(up, ap, rs, ts))
    ck = tck.load_checkpoint(tmp_path / 'run')
    spec = ttrain.StageSpec(**SPEC)
    unet, atms = ttrain.make_models(spec, 'cpu')
    unet.load_state_dict(ck['unet'])
    atms.load_state_dict(ck['atms'])
    r_opt = make_reconstruction_optimizer(unet.parameters(), LR, UPE)
    t_opt = make_transform_optimizer(atms.parameters(), LR, EPOCHS, UPE)
    tck.load_optimizer(*r_opt, unet, ck['recon_opt'], ck['recon_sched'])
    tck.load_optimizer(*t_opt, atms, ck['trans_opt'], ck['trans_sched'])
    assert r_opt[1].last_epoch == t_opt[1].last_epoch == 1
    ttrain.train_step(spec, unet, atms, r_opt, t_opt, torch_batch(one_jax_step['batch']))
    refs = {**unet_state_dict(up2), **atms_state_dict(ap2)}
    n_checked = 0
    for name, p in list(unet.named_parameters()) + list(atms.named_parameters()):
        if is_pre_norm_bias(name):
            continue
        g = p.grad.numpy()
        sel = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(p.detach().numpy()[sel], refs[name].numpy()[sel],
                                   atol=1e-5, err_msg=name)
        n_checked += int(sel.sum())
        opt = r_opt[0] if p in r_opt[0].state else t_opt[0]
        assert float(opt.state[p]['step']) == 2.0
    assert n_checked > 0
    assert r_opt[1].last_epoch == t_opt[1].last_epoch == 2


def test_epix2vox_optimizer_import(tmp_path):
    """(E)Pix2Vox's ``multi_transform`` state (Adam over 'main', then Adam over
    'merger'): each group's moments land on its params' names, with its count.
    The params are the model's encoder and merger (their layout maps), at random
    values, after two updates with random gradients."""
    spec = jtrain.StageSpec(**dict(SPEC, model_type='hybrid-EPix2Vox'))
    shapes = jax.eval_shape(lambda k: jtrain.init_params(spec, k), jax.random.key(0))
    rng = np.random.default_rng(0)
    fill = lambda s: rng.normal(size=s.shape).astype(np.float32)   # noqa: E731
    enc = shapes[0]['params']['encoder']
    some = {k: enc[k] for k in sorted(enc)[:3]}
    up = {'params': jax.tree_util.tree_map(fill, {'encoder': some,
                                                  'merger': shapes[0]['params']['merger']})}
    ap = jax.tree_util.tree_map(fill, shapes[1])
    opt = jopt.make_epix2vox_optimizer(UPE)
    state = opt.init(up)
    for _ in range(2):
        _, state = opt.update(jax.tree_util.tree_map(fill, up), state, up)
    t_state = jopt.make_transform_optimizer(LR, EPOCHS, UPE).init(ap)
    jsave(tmp_path / 'run', run_state(up, ap, state, t_state))
    ck = tck.load_checkpoint(tmp_path / 'run')
    assert_state_dicts_equal(ck['unet'], epix2vox_state_dict(to_np(up)))
    moments = ck['recon_opt']['moments']
    names = {'main': [n for n in moments if not n.startswith('merger.')],
             'merger': [n for n in moments if n.startswith('merger.')]}
    assert names['main'] and names['merger']
    for group, inner in state.inner_states.items():
        adam = inner.inner_state[0]
        masked = {'params': {k: v for k, v in adam.mu['params'].items()
                             if (k == 'merger') == (group == 'merger')}}
        mu = epix2vox_state_dict(to_np(masked))
        nu = epix2vox_state_dict(to_np({'params': {
            k: adam.nu['params'][k] for k in masked['params']}}))
        assert sorted(mu) == sorted(names[group])
        for n in names[group]:
            assert torch.equal(moments[n]['exp_avg'], mu[n]), n
            assert torch.equal(moments[n]['exp_avg_sq'], nu[n]), n
            assert float(moments[n]['step']) == float(adam.count) == 2.0
    assert ck['recon_sched'] == {'last_epoch': 2}


def test_import_cli_writes_the_port_file_without_jax(tmp_path, one_jax_step):
    """``python -m acquisition_focus_tpu_torch.scripts.import_orbax SRC DST``
    writes the import as a ``torch.save`` file, and neither it nor the import
    loads jax, flax, optax, orbax or the JAX package."""
    up, ap, rs, ts = one_jax_step['step1']
    jsave(tmp_path / 'run', run_state(up, ap, rs, ts))
    code = (
        "import sys\n"
        "from acquisition_focus_tpu_torch.scripts.import_orbax import main\n"
        f"main([{str(tmp_path / 'run')!r}, {str(tmp_path / 'run.pt')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', 'orbax', 'acquisition_focus_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith('ok'), out.stderr[-3000:]
    written = torch.load(tmp_path / 'run.pt', weights_only=True)
    ref = tck.load_checkpoint(tmp_path / 'run')
    assert_state_dicts_equal(written['unet'], ref['unet'])
    assert_state_dicts_equal(written['atms'], ref['atms'])
    for name in ('recon_opt', 'trans_opt'):
        for n, m in ref[name]['moments'].items():
            for k in m:
                assert torch.equal(written[name]['moments'][n][k], m[k]), (name, n, k)
    assert written['recon_sched'] == ref['recon_sched']


@pytest.fixture(scope='module')
def datasets():
    cfg = trunner.load_config(overrides=RUN)
    return BaseDataset.from_cases(phantom_cases(6, (16,) * 3, (1.5,) * 3, 2), cfg)


def test_run_dl_resumes_a_jax_pause(tmp_path, datasets, monkeypatch, capsys):
    """The JAX runner pauses after epoch 0 (``stop_at_epoch``); the port's
    ``run_dl`` given that orbax ``_pause`` directory as ``model_checkpoint_path``
    resumes at epoch 1 with its params converted and both optimizers at JAX's
    counts (the port's first step sees exactly those), where it once skipped the
    directory and trained afresh from epoch 0. No validation cases: the JAX
    runner then compiles its training step only."""
    fold = (0, ([0, 1], []))
    cfg = dict(epochs=2, do_augment_input_orientation=False, base_features=[2, 4, 4])
    pause = jrun_dl(str(tmp_path / 'jax'), run_config(tmp_path / 'jax', stop_at_epoch=1,
                                                      **cfg),
                    fold, training_dataset=datasets, run_name='jax')
    assert pause.endswith('jax_pause')
    jck = tck.load_checkpoint(pause)
    seen = []

    def spy(spec, unet, atms, recon_opt, trans_opt, *args, **kwargs):
        if not seen:
            seen.append(({n: p.detach().clone() for n, p in unet.named_parameters()},
                         {n: p.detach().clone() for n, p in atms.named_parameters()},
                         recon_opt[1].last_epoch, trans_opt[1].last_epoch,
                         {float(s['step']) for s in recon_opt[0].state.values()}))
        return ttrain.train_step(spec, unet, atms, recon_opt, trans_opt, *args, **kwargs)

    monkeypatch.setattr(trunner, 'train_step', spy)
    trunner.run_dl(str(tmp_path / 'torch'),
                   run_config(tmp_path / 'torch', model_checkpoint_path=pause, **cfg),
                   fold, training_dataset=datasets, run_name='torch', device='cpu')
    assert "(resuming at epoch 1)" in capsys.readouterr().out
    unet_p, atm_p, r_count, t_count, steps = seen[0]
    assert_state_dicts_equal(unet_p, jck['unet'])
    assert_state_dicts_equal(atm_p, jck['atms'])
    assert r_count == jck['recon_sched']['last_epoch'] == t_count == 2   # 2 updates
    assert steps == {2.0}


# ---------------------------------------------------------------- segmenters

def test_jax_segmenter_directory_segments_as_its_torch_file(tmp_path):
    """A JAX segmenter's orbax directory ({'params', 'num_classes'}) through
    ``make_segment_fn`` labels a volume as the same weights saved with
    ``torch.save``, voxel for voxel."""
    rng = np.random.default_rng(0)
    jm = JSegUnet2D(num_classes=3, features=(4, 8))
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 1)))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(np.float32), params)
    jsave(tmp_path / 'seg', {'params': params, 'num_classes': 3})
    torch.save({'params': segunet_state_dict(params), 'num_classes': 3}, tmp_path / 'seg.pt')
    vol = torch.from_numpy(rng.normal(size=(16,) * 3).astype(np.float32))
    got, ref = (tseg.make_segment_fn(str(tmp_path / name), 0, 3, tile_size=(16, 16),
                                     device='cpu')(vol) for name in ('seg', 'seg.pt'))
    assert got.shape == (16,) * 3 and torch.equal(got, ref)
    assert len(torch.unique(ref)) > 1


# ---------------------------------------------------------------- the card's fixture

ORBAX_DATA = Path(__file__).parent / 'torch_data'
ORBAX_CONFIG = dict(RUN, epochs=2, stop_at_epoch=1, do_augment_input_orientation=False,
                    base_features=[2, 4, 4], use_affine_theta=True)


def write_orbax_fixture(out_dir, work_dir):
    """The test data ``chip_smoke.py`` loads on the card, where no JAX package
    runs: a JAX ``run_dl`` of the tiny spec pauses after epoch 0 and its orbax
    ``_pause`` directory is imported by ``python -m
    acquisition_focus_tpu_torch.scripts.import_orbax`` into ``orbax_run.pt``; a
    batch (``orbax_batch.npz``) and, in ``orbax_run.json``, the run's config
    overrides, the class count and the JAX package's step loss on that batch
    from the paused state (the mean microbatch loss, before the update)."""
    out_dir, work_dir = Path(out_dir), Path(work_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = trunner.load_config(overrides=RUN)
    train = BaseDataset.from_cases(phantom_cases(6, (16,) * 3, (1.5,) * 3, 2), cfg)
    pause = jrun_dl(str(work_dir), run_config(work_dir, **{
        k: v for k, v in ORBAX_CONFIG.items() if k not in RUN or RUN[k] != v}),
        (0, ([0, 1], [])), training_dataset=train, run_name='jax')
    out = subprocess.run([sys.executable, '-m', 'acquisition_focus_tpu_torch.scripts.'
                          'import_orbax', pause, str(out_dir / 'orbax_run.pt')],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    config = jload_config(overrides=ORBAX_CONFIG)
    spec = jspec_from_config(config, len(train.label_tags), len(config['base_views']))
    batch = make_batch(spec, np.random.default_rng(BATCH_SEED))
    np.savez(out_dir / 'orbax_batch.npz', **batch)
    params = jload_checkpoint(pause)
    unet_j, atms_j = jtrain.make_models(spec)
    losses = [float(jtrain.forward(spec, unet_j, params['unet_params'], atms_j,
                                   params['atm_params'],
                                   {k: jnp.asarray(v[i]) for k, v in batch.items()},
                                   None, train=True)[0])
              for i in range(spec.num_grad_accum_steps)]
    (out_dir / 'orbax_run.json').write_text(json.dumps(dict(
        config=ORBAX_CONFIG, num_classes=len(train.label_tags),
        jax_loss=float(np.mean(losses))), indent=1) + '\n')


def test_committed_orbax_fixture_is_regenerated(tmp_path):
    """``tests/torch_data/orbax_run.*``, which ``chip_smoke.py`` loads on the card,
    is what :func:`write_orbax_fixture` writes today: the same tensors, batch and
    JAX loss; and the port's float32 step on the CPU from the imported state
    takes that loss within 1e-4 (rel.), as the card must."""
    write_orbax_fixture(tmp_path / 'out', tmp_path / 'work')
    new, old = (torch.load(d / 'orbax_run.pt', weights_only=True)
                for d in (tmp_path / 'out', ORBAX_DATA))

    def flat(tree, prefix=''):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f'{prefix}/{k}').items()}
        return {prefix: tree}

    a, b = flat(new), flat(old)
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(v, b[k], rtol=1e-5, atol=1e-7, msg=k)
        else:
            assert v == b[k], k
    for name in ('orbax_batch.npz', 'orbax_run.json'):
        if name.endswith('.json'):
            new_j, old_j = (json.loads((d / name).read_text())
                            for d in (tmp_path / 'out', ORBAX_DATA))
            np.testing.assert_allclose(new_j.pop('jax_loss'), old_j.pop('jax_loss'),
                                       rtol=1e-6)
            assert new_j == old_j
        else:
            with np.load(tmp_path / 'out' / name) as x, np.load(ORBAX_DATA / name) as y:
                assert x.files == y.files
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k])
    assert sum(p.stat().st_size for p in ORBAX_DATA.glob('orbax_*')) < 1_000_000
    from chip_smoke import orbax_fixture_step
    loss, jax_loss = orbax_fixture_step(ORBAX_DATA, 'cpu')
    assert abs(loss - jax_loss) <= 1e-4 * abs(jax_loss), (loss, jax_loss)
