"""The training step's spans and counters (``utils/spans.py``) on the CPU: a tiny
``train_step`` (accum 2, one trained ATM view, the selective decoder regions)
with spans on, off and under a CPU ``torch.profiler``; the per-step counter
ring; ``run_dl``'s per-epoch export (config key ``trace_spans``); and the
collective counters on gloo ranks. On the CPU the autograd engine runs backward
on the calling thread; :func:`test_a_span_on_another_thread_takes_the_backward_as_parent`
opens one on a thread of its own, and the ``cuda`` test sees autograd's thread
on the card:

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_spans.py -q

This module imports no JAX.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_mesh_workers as workers
from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset
from acquisition_focus_tpu_torch.data.phantom import phantom_cases
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.engine.config import PORT_DEFAULTS, load_config
from acquisition_focus_tpu_torch.engine.optimizers import (
    make_reconstruction_optimizer, make_transform_optimizer)
from acquisition_focus_tpu_torch.engine.runner import run_dl
from acquisition_focus_tpu_torch.ops.kernels import _lib
from acquisition_focus_tpu_torch.parallel.mesh import spawn_ranks
from acquisition_focus_tpu_torch.utils import spans

SPEC = dict(
    n_views=2, num_classes=3, n_active_views=2,
    view_optimization_mode='opt-current-fix-previous', use_affine_theta=True,
    hires_fov_mm=(24.0,) * 3, hires_fov_vox=(16,) * 3, slice_fov_mm=(24.0, 24.0, 1.5),
    slice_fov_vox=(16, 16, 1), prescan_fov_mm=(24.0,) * 3, prescan_fov_vox=(16,) * 3,
    num_grad_accum_steps=2, compute_dtype='float32', augment_input=False,
    base_features=(2, 4, 4, 8), locnet_width=2)
ACCUM = SPEC['num_grad_accum_steps']
PARENTS = {'af.step': None, 'af.forward': 'af.step', 'af.backward': 'af.step',
           'af.recompute': 'af.backward', 'af.optimizer': 'af.step'}


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def spans_on():
    spans.clear_records()
    spans.enable()
    try:
        yield
    finally:
        spans.enable(False)
        spans.clear_records()


def make_batch(seed=0, B=1):
    rng = np.random.default_rng(seed)
    S = SPEC['hires_fov_vox'][0]
    return {'label': rng.integers(0, SPEC['num_classes'], (ACCUM, B, S, S, S)).astype(np.int64),
            'nii_affine': np.broadcast_to(np.diag([1.5, 1.5, 1.5, 1.0]),
                                          (ACCUM, B, 4, 4)).astype(np.float32).copy(),
            'view_affines': np.broadcast_to(np.eye(4, dtype=np.float32),
                                            (ACCUM, SPEC['n_views'], B, 4, 4)).copy()}


def setup(**spec_kw):
    spec = ttrain.StageSpec(**dict(SPEC, **spec_kw))
    unet, atms = ttrain.make_models(spec, 'cpu')
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(0))
    return (spec, unet, atms, make_reconstruction_optimizer(unet.parameters(), 1e-3, 2),
            make_transform_optimizer(atms.parameters(), 1e-3, 8, 2))


def run_step(**spec_kw):
    spec, unet, atms, r_opt, t_opt = setup(**spec_kw)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    out = ttrain.train_step(spec, unet, atms, r_opt, t_opt, batch)
    return spec, unet, atms, out


def n_regions(spec, unet):
    """The recompute regions of one microbatch: each trained ATM view's chain and
    each decoder stage."""
    return int(spec.view_train_mask().sum()) + len(unet.decoder)


@pytest.fixture(scope='module')
def traced():
    """One step with spans on: its records, its counts, and its regions."""
    spans.clear_records()
    spans.enable()
    try:
        spec, unet, atms, _ = run_step()
    finally:
        spans.enable(False)
    records = spans.records()
    spans.clear_records()
    return records, spans.recent_steps(1)[0], n_regions(spec, unet)


# ---------------------------------------------------------------- spans on

@pytest.mark.parametrize('name', sorted(PARENTS))
def test_each_span_has_its_parent_and_the_step_id(traced, name):
    records, step, _ = traced
    mine = [r for r in records if r.name == name]
    assert mine
    assert {r.parent for r in mine} == {PARENTS[name]}
    assert {r.step for r in mine} == {step.step}


def test_spans_per_step(traced):
    records, _, regions = traced
    names = [r.name for r in records]
    assert (names.count('af.step'), names.count('af.optimizer')) == (1, 1)
    assert names.count('af.forward') == names.count('af.backward') == ACCUM
    assert names.count('af.recompute') == regions * ACCUM
    assert 'af.grad_sync' not in names and 'af.stage' not in names


def test_each_span_lies_inside_its_parent(traced):
    records, _, _ = traced
    step = next(r for r in records if r.name == 'af.step')
    backwards = [r for r in records if r.name == 'af.backward']
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent == 'af.step':
            assert step.start_ns <= r.start_ns and r.end_ns <= step.end_ns
        if r.name == 'af.recompute':
            assert any(b.start_ns <= r.start_ns and r.end_ns <= b.end_ns for b in backwards)


def test_recompute_replays_each_region_once_per_microbatch(traced):
    _, step, regions = traced
    assert regions == 4
    assert step.counts['recompute.replays'] == regions * ACCUM


@pytest.mark.parametrize('spec_kw, selective', [
    ({}, True), (dict(decoder_save_names=('conv_out',)), True),
    (dict(atm_remat=True, unet_remat=True), False)])
def test_recompute_ops_counted_under_the_selective_policy_only(spec_kw, selective):
    spec, unet, _, _ = run_step(**spec_kw)
    counts = spans.recent_steps(1)[0].counts
    assert counts['recompute.replays'] == ACCUM * n_regions(spec, unet) + (
        0 if selective else ACCUM)          # unet_remat: the skip connector's region too
    assert (counts.get('recompute.ops', 0) > 0) == selective


# kept call sites of one replay on the CPU: each decoder stage's three convs (up,
# a, b; K1f's concat, the fourth on the card, is the plain composition here) and
# each trained ATM chain's nine
DECODER_SITES, ATM_SITES = 3, 9


@pytest.mark.parametrize('spec_kw, decoder_sites, atm_sites', [
    ({}, DECODER_SITES, ATM_SITES),
    (dict(decoder_save_names=()), 0, ATM_SITES),
    (dict(atm_remat=True, unet_remat=True), 0, 0)])
def test_recompute_served_counts_the_kept_call_sites_of_each_replay(
        spec_kw, decoder_sites, atm_sites):
    spec, unet, _, _ = run_step(**spec_kw)
    counts = spans.recent_steps(1)[0].counts
    n_atms = int(spec.view_train_mask().sum())
    assert counts.get('recompute.served', 0) == ACCUM * (
        decoder_sites * len(unet.decoder) + atm_sites * n_atms)


def test_a_span_on_another_thread_takes_the_backward_as_parent(spans_on):
    """As autograd's thread on the card: a thread with no span open takes the
    innermost span open on the step's thread."""
    seen = []

    def other():
        with spans.span('af.recompute'):
            seen.append(threading.get_ident())

    with spans.step():
        with spans.span('af.backward'):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen
    rec = next(r for r in spans.records() if r.name == 'af.recompute')
    assert (rec.parent, rec.thread) == ('af.backward', seen[0])
    assert rec.thread != threading.get_ident()


# ---------------------------------------------------------------- spans off

def test_spans_leave_the_step_bit_equal():
    outs = []
    for on in (True, False):
        spans.enable(on)
        try:
            _, unet, atms, out = run_step()
        finally:
            spans.enable(False)
        outs.append((out, {n: p.detach().clone() for m in (unet, atms)
                           for n, p in m.named_parameters()}))
    spans.clear_records()
    (a, pa), (b, pb) = outs
    assert torch.equal(a['loss'], b['loss']) and torch.equal(a['dice'], b['dice'])
    assert pa.keys() == pb.keys() and all(torch.equal(pa[n], pb[n]) for n in pa)


def test_off_records_nothing_and_costs_no_span_object():
    assert not spans.enabled() and not PORT_DEFAULTS['trace_spans']
    spans.clear_records()
    assert spans.span('af.forward') is spans.span('af.backward')
    run_step()
    assert spans.records() == []
    assert spans.recent_steps(1)[0].counts['recompute.replays'] == 4 * ACCUM


# ---------------------------------------------------------------- the profiler's trace

@pytest.fixture(scope='module')
def profiled():
    """One step under a CPU profiler, spans off: the ``af.*`` events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_step()
    assert not spans.records()
    return [e for e in prof.events() if e.name.startswith('af.')]


@pytest.mark.parametrize('name', sorted(PARENTS))
def test_spans_nest_in_the_profiler_trace(profiled, name):
    mine = [e for e in profiled if e.name == name]
    assert mine and all(e.is_user_annotation for e in mine)

    def af_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith('af.'):
            p = p.cpu_parent
        return p.name if p is not None else None

    assert {af_parent(e) for e in mine} == {PARENTS[name]}


# ---------------------------------------------------------------- counters

def test_step_closes_its_counts_into_the_ring():
    spans.count('test.outside')
    for k in range(spans.RING_STEPS + 2):
        with spans.step():
            spans.count('test.inside', k)
    ring = spans.recent_steps()
    assert len(ring) == spans.RING_STEPS
    assert [s.counts.get('test.inside', 0) for s in ring] == list(range(2, spans.RING_STEPS + 2))
    assert all('test.outside' not in s.counts for s in ring)
    assert [s.step for s in ring] == sorted(s.step for s in ring)
    assert spans.recent_steps(3) == ring[-3:]
    totals = spans.totals()
    spans.reset('test.')
    assert totals['test.outside'] == 1 and not any(k.startswith('test.') for k in spans.totals())


def test_launches_are_a_view_of_the_launch_counters():
    _lib.reset_launch_counts()
    assert dict(_lib.LAUNCHES) == dict.fromkeys(_lib.LAUNCHES, 0)
    spans.count('launch.conv3d_fwd', 2)
    spans.count('launch.volume_resample')
    assert _lib.LAUNCHES['conv3d_fwd'] == 2 and _lib.LAUNCHES == dict(
        dict.fromkeys(_lib.LAUNCHES, 0), conv3d_fwd=2, volume_resample=1)
    _lib.reset_launch_counts()
    assert set(_lib.LAUNCHES.values()) == {0}
    with pytest.raises(KeyError):
        _lib.LAUNCHES['no_such_kernel']


def test_per_step_export_takes_the_means_since_the_marks(spans_on):
    span_before, counts_before = spans.span_ns(), spans.totals()
    for _ in range(2):
        with spans.step():
            with spans.span('af.forward'):
                spans.count('test.per_step', 3)
    got = spans.per_step(span_before, counts_before, 2)
    spans.reset('test.')
    assert got['perf/count/test.per_step'] == 3
    total_ms = sum(r.ms for r in spans.records() if r.name == 'af.forward')
    assert got['perf/span/af.forward_ms'] == pytest.approx(total_ms / 2)
    assert set(got) >= {'perf/span/af.step_ms', 'perf/span/af.forward_ms'}
    assert spans.per_step(span_before, counts_before, 0) == {}


# ---------------------------------------------------------------- run_dl's export

RUN = dict(
    base_views=['p2CH', 'p2CH'], view_optimization_mode='opt-all', use_affine_theta=True,
    hires_fov_mm=[24.0] * 3, hires_fov_vox=[16] * 3, slice_fov_mm=[24.0, 24.0, 1.5],
    slice_fov_vox=[16, 16, 1], prescan_fov_mm=[24.0] * 3, prescan_fov_vox=[16] * 3,
    compute_dtype='float32', base_features=[2, 4, 4, 8], locnet_width=2, batch_size=1,
    num_grad_accum_steps=2, val_batch_size=1, metrics_every=1000, do_output=False,
    save_every=None, use_caching=False, epochs=1)


@pytest.mark.parametrize('trace_spans', [True, False])
def test_run_dl_logs_the_spans_per_step_each_epoch(tmp_path, trace_spans):
    cfg = load_config(overrides=dict(RUN, log_dir=str(tmp_path / 'runs'),
                                     mdl_save_prefix=str(tmp_path / 'models'),
                                     trace_spans=trace_spans))
    train = BaseDataset.from_cases(phantom_cases(5, (16,) * 3, (1.5,) * 3, 2), cfg)
    run_dl(str(tmp_path), cfg, (0, ([0, 1, 2, 3], [4])), training_dataset=train,
           run_name='spans', device='cpu')
    assert not spans.enabled()
    spans.clear_records()
    lines = [json.loads(x) for x in
             (tmp_path / 'runs' / 'spans' / 'metrics.jsonl').read_text().splitlines()]
    keys = {k for rec in lines for k in rec if k.startswith(('perf/span/', 'perf/count/'))}
    if not trace_spans:
        assert keys == set()
        return
    assert keys >= {f'perf/span/{n}_ms' for n in
                    ('af.step', 'af.stage', 'af.forward', 'af.backward', 'af.recompute',
                     'af.optimizer')} | {'perf/count/recompute.replays',
                                         'perf/count/recompute.ops'}
    rec = next(r for r in lines if 'perf/span/af.step_ms' in r)
    assert rec['perf/count/recompute.replays'] == ACCUM * (2 + 3)   # 2 ATM views, 3 stages
    assert 0 < rec['perf/span/af.forward_ms'] < rec['perf/span/af.step_ms']


# ---------------------------------------------------------------- collectives

@pytest.fixture(scope='module')
def mesh_counts(tmp_path_factory):
    out = tmp_path_factory.mktemp('collectives')
    spec_kw = dict(SPEC, view_optimization_mode='opt-all')
    spawn_ranks(workers.world, 2, args=([('collective_counts', spec_kw, make_batch(B=2), 0)],
                                        str(out)), threads=1)
    return torch.load(out / '0.pt', weights_only=False)


def test_collective_counters_count_calls_and_input_bytes(mesh_counts):
    assert (mesh_counts['after_reduce']['collective.calls'],
            mesh_counts['after_reduce']['collective.bytes']) == (1, 12)
    assert (mesh_counts['after_gather']['collective.calls'],
            mesh_counts['after_gather']['collective.bytes']) == (2, 12 + 32)
    kept = mesh_counts['kept']
    assert (kept['after_forward']['collective.calls'],
            kept['after_forward']['collective.bytes']) == (3, 12 + 32 + 32)
    # the replay takes the kept output: nothing sent, nothing counted
    assert all(kept['after_backward'][k] == kept['after_forward'][k]
               for k in ('collective.calls', 'collective.bytes'))
    assert not any('_c10d' in op for op in kept['backward_ops'])
    assert kept['after_backward']['recompute.served'] == 1 and kept['grad_ok']


def test_a_mesh_step_counts_its_collectives_and_spans_its_gradient_sync(mesh_counts):
    counts = mesh_counts['step']
    # one flat gradient bucket, the loss's mean, the dice's gather
    assert counts['collective.calls'] == 3
    assert counts['collective.bytes'] == mesh_counts['expected_bytes']
    assert ('af.grad_sync', 'af.step', mesh_counts['step_id']) in mesh_counts['records']


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
def test_recompute_runs_on_autograds_thread_on_the_card(spans_on):
    """A narrow U-Net at 128^3 on the card under the default policy: each decoder
    stage's replay runs on autograd's thread, inside the main thread's
    ``af.backward``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from acquisition_focus_tpu_torch.models.hybrid_unet import HybridUnet
    unet = HybridUnet(3, 2, base_features=(4, 8, 8), dtype=torch.bfloat16,
                      use_pallas_conv='fwd', remat_skips=False,
                      decoder_save_names=('conv_out', 'conv_in0')).cuda()
    x = torch.rand(1, 6, 128, 128, device='cuda')
    aff = torch.eye(4, device='cuda').expand(3, 1, 4, 4).contiguous()
    with spans.step():
        y = unet(x, aff).float().square().mean()
        with spans.span('af.backward'):
            y.backward()
    torch.cuda.synchronize()
    replays = [r for r in spans.records() if r.name == 'af.recompute']
    assert len(replays) == len(unet.decoder)
    assert all(r.parent == 'af.backward' and r.thread != threading.get_ident()
               for r in replays)
