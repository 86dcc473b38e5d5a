"""The recompute switches (``atm_remat``, ``unet_remat``, ``decoder_save_names``)
against the JAX package's, on the CPU in float32, and the structure of the
port's recompute regions (``models/recompute.py``).

Each setting's ``train_step`` is held against the JAX package's ``train_step`` in
the same setting at the tolerances of ``test_torch_train_step.py`` (the default's
there); in every setting the port's gradient is bit-equal to its default's; the
bytes a forward leaves held for backward fall in the order full remat < default
policy < no regions (the port before recompute); no convolution runs again in
backward under the default policy, and one does under each full remat. No
dispatch mode is active in a region's forward or replay but the first replay's
count of its ops; against selective checkpointing's policy under the same names
(the port's earlier regions, rebuilt here) the gradients are bit-equal and
the forward holds the same bytes. On the card, the kernels' launches under
recompute: ``test_torch_kernels.py``.
"""

import functools
import gc

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from acquisition_focus_tpu.models.hybrid_unet import HybridUnet as JHybridUnet
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.models import recompute
from acquisition_focus_tpu_torch.models.hybrid_unet import (
    Conv3x3x3, HybridUnet, _norm_act, decoder_save_levels)
from test_torch_train_step import (
    BATCH_SEED, SKINNY, is_pre_norm_bias, make_batch, run_step_pair, torch_batch,
    unet_pairs, atm_pairs)

SETTINGS = {
    'default': {},
    'atm_remat': dict(atm_remat=True),
    'unet_remat': dict(unet_remat=True),
    "('conv_out',)": dict(decoder_save_names=('conv_out',)),
    "('conv_out','conv_in')": dict(decoder_save_names=('conv_out', 'conv_in')),
    '()': dict(decoder_save_names=()),
}
BOTH = dict(atm_remat=True, unet_remat=True)
CONV_OPS = ('aten.convolution.default', 'afocus.conv3d_fwd.default')


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Many small torch ops: with several test workers on one machine, torch's
    default of one intra-op thread per core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class OpCounts(TorchDispatchMode):
    """Counts the dispatcher ops run while active, by name."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] = self.counts.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))

    def convs(self):
        return sum(self.counts.get(op, 0) for op in CONV_OPS)


class LiveOutputs(TorchDispatchMode):
    """Keeps a weak reference to the storage of every op output while active;
    :meth:`live_bytes` sums the storages still alive, each once."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.refs.append((StorageWeakRef(s), s.data_ptr(), s.nbytes()))
        return out

    def live_bytes(self):
        gc.collect()
        return sum({ptr: n for ref, ptr, n in self.refs if not ref.expired()}.values())


def skinny_models(options):
    spec = ttrain.StageSpec(**dict(SKINNY, **options))
    unet, atms = ttrain.make_models(spec, 'cpu')
    ttrain.init_params(unet, atms, torch.Generator().manual_seed(0))
    return spec, unet, atms


@pytest.fixture(scope='module')
def micro():
    spec = ttrain.StageSpec(**SKINNY)
    batch = torch_batch(make_batch(spec, np.random.default_rng(BATCH_SEED)))
    return {k: v[0] for k, v in batch.items()}


def microbatch_grads(options, micro, counts=None):
    """Every parameter gradient of one microbatch under ``options``, from the
    same weights; ``counts``: an OpCounts active during backward."""
    spec, unet, atms = skinny_models(options)
    loss, _ = ttrain.forward(spec, unet, atms, micro)
    if counts is None:
        loss.backward()
    else:
        with counts:
            loss.backward()
    return {f'{i}.{n}': p.grad for i, m in enumerate((unet, atms))
            for n, p in m.named_parameters()}


@pytest.fixture(scope='module')
def default_grads(micro):
    return microbatch_grads({}, micro)


# ---------------------------------------------------------------- against JAX

# each setting of SETTINGS but the default, which test_torch_train_step.py's step
# pair holds against JAX already; atm_remat and the decoder's names are
# independent, so atm_remat rides with one of the names (one JAX compile less).
# Three U-Net levels (two decoder stages, so 'conv_in' is not 'conv_in0') keep each
# JAX compile at ~25 s.
JAX_SPEC = dict(SKINNY, base_features=(2, 4, 4))
JAX_SETTINGS = {
    "atm_remat+('conv_out',)": dict(atm_remat=True, decoder_save_names=('conv_out',)),
    'unet_remat': SETTINGS['unet_remat'],
    "('conv_out','conv_in')": SETTINGS["('conv_out','conv_in')"],
    '()': SETTINGS['()'],
}


@pytest.fixture(scope='module', params=list(JAX_SETTINGS))
def setting_pair(request):
    return run_step_pair(dict(JAX_SPEC, **JAX_SETTINGS[request.param]), jax_grads=False)


def test_setting_matches_jax(setting_pair):
    """One train_step in the setting, the port's against the JAX package's: loss
    (rtol 1e-5), Dice (atol 1e-6), and the updated params (atol 1e-5 wherever
    |grad| > 1e-3 of the leaf's max, the port's gradient standing for both: it is
    held within 1e-4 of JAX's in ``test_torch_train_step.py``)."""
    d = setting_pair
    np.testing.assert_allclose(float(d['metrics_t']['loss']), d['loss_j'], rtol=1e-5)
    np.testing.assert_allclose(d['metrics_t']['dice'].numpy(), d['dice_j'], atol=1e-6,
                               equal_nan=True)
    n_checked = 0
    for name, ref, p in (unet_pairs(d['new_up'], d['unet'])
                         + atm_pairs(d['new_ap'], d['atms'])):
        if is_pre_norm_bias(name):
            continue
        g = p.grad.numpy()
        sel = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(p.detach().numpy()[sel], ref[sel], atol=1e-5,
                                   err_msg=name)
        n_checked += int(sel.sum())
    assert n_checked > 0


# ---------------------------------------------------------------- the port itself

@pytest.mark.parametrize('setting', list(SETTINGS) + ['both'])
def test_gradients_bit_equal_to_the_default(setting, micro, default_grads):
    options = BOTH if setting == 'both' else SETTINGS[setting]
    grads = microbatch_grads(options, micro)
    assert grads.keys() == default_grads.keys()
    for name, g in grads.items():
        assert torch.equal(g, default_grads[name]), name


@pytest.mark.parametrize('setting,convs_in_backward', [
    ('default', 0), ("('conv_out',)", 0), ("('conv_out','conv_in')", 0),
    # full remat: each ATM chain's 9 convs for the 2 training views; the decoder's
    # 3 stages of 3 convs (up, a, b); the decoder with no conv output saved
    ('atm_remat', 18), ('unet_remat', 9), ('()', 9)])
def test_convs_in_backward(setting, convs_in_backward, micro):
    """No convolution runs in backward under a policy that saves 'conv_out':
    the regions rebuild the norms and activations from the kept conv outputs.
    A full remat runs each of its region's convs once more."""
    counts = OpCounts()
    microbatch_grads(SETTINGS[setting], micro, counts)
    assert counts.convs() == convs_in_backward
    assert counts.counts.get('aten.convolution_backward.default', 0) > 0


def test_saved_bytes_order(micro, monkeypatch):
    """The bytes a forward leaves held for backward (the storages of op outputs
    still alive after it: autograd residuals and the regions' kept outputs): full
    remat < the default policy < no regions at all (every residual kept, as the
    port before recompute). Region inputs and outputs stay in all three."""
    def held(options):
        spec, unet, atms = skinny_models(options)
        live = LiveOutputs()
        with live:
            loss, aux = ttrain.forward(spec, unet, atms, micro)
        del aux
        return live.live_bytes(), loss

    full, loss_full = held(BOTH)
    policy, loss_policy = held({})
    monkeypatch.setattr(recompute, 'region', lambda fn, *args, save_ops=None: fn(*args))
    save_all, loss_all = held({})
    assert full < policy < save_all, (full, policy, save_all)
    assert float(loss_full.detach()) == float(loss_policy.detach()) == float(loss_all.detach())


def test_kernel_op_kept_by_the_policy():
    """At a shape K3 takes (W % 128 == 0), the conv runs as K3's dispatcher op
    (its plain version on the CPU): the policy keeps its output, so backward runs
    it no more; a full remat runs it again."""
    torch.manual_seed(0)
    conv_a, conv_b = Conv3x3x3(4, 4, 'fwd'), Conv3x3x3(4, 4, 'fwd')
    norm = torch.nn.InstanceNorm3d(4, affine=True)
    x = torch.randn(1, 4, 8, 4, 128)

    def block(x):
        return conv_b(_norm_act(norm, conv_a(x)))

    grads = {}
    for name, save_ops in (('policy', recompute.CONV_OUT), ('full', None), ('none', ())):
        fwd, bwd = OpCounts(), OpCounts()
        with fwd:
            out = recompute.region(block, x, save_ops=save_ops)
        with bwd:
            out.square().sum().backward()
        assert fwd.counts.get('afocus.conv3d_fwd.default') == 2
        assert bwd.counts.get('afocus.conv3d_fwd.default', 0) == \
            {'policy': 0, 'full': 2, 'none': 2}[name]
        grads[name] = [p.grad.clone() for p in (conv_a.weight, conv_b.weight)]
        for p in (conv_a.weight, conv_b.weight):
            p.grad = None
    for name in ('full', 'none'):
        assert all(torch.equal(a, b) for a, b in zip(grads[name], grads['policy']))


class DispatchStack(torch.nn.Module):
    """A decoder stage that notes the torch dispatch stack's depth at each call,
    under the phase its ``depths`` key names ('forward' or 'replay')."""

    def __init__(self, stage):
        super().__init__()
        self.stage, self.phase, self.depths = stage, None, {'forward': [], 'replay': []}

    def forward(self, *args):
        self.depths[self.phase].append(torch._C._len_torch_dispatch_stack())
        return self.stage(*args)


def test_no_dispatch_mode_in_the_forward_or_the_replay(micro):
    """No dispatch mode is active inside a kept-set region's ``fn``, in its
    forward or in its replay; only the first replay of each region signature
    counts its ops under one (``recompute.ops``)."""
    spec, unet, atms = skinny_models({})
    probes = [DispatchStack(stage) for stage in unet.decoder]
    unet.decoder = torch.nn.ModuleList(probes)
    for _ in range(3):
        for probe in probes:
            probe.phase = 'forward'
        loss, _ = ttrain.forward(spec, unet, atms, micro)
        for probe in probes:
            probe.phase = 'replay'
        loss.backward()
    for probe in probes:
        assert probe.depths == {'forward': [0, 0, 0], 'replay': [1, 0, 0]}


def sac_region(fn, *args, save_ops=None):
    """The recompute region as the port ran it before: ``torch.utils.checkpoint``
    with selective checkpointing's dispatch mode keeping the outputs of the
    dispatcher ops behind the kept names (the reference of the parity test)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    context_fn = noop_context_fn
    if save_ops is not None:
        ops = frozenset().union(*(SAC_OPS[name] for name in save_ops))

        def policy(ctx, op, *a, **k):
            return (CheckpointPolicy.MUST_SAVE if op in ops
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        context_fn = functools.partial(create_selective_checkpoint_contexts, policy)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn)


SAC_OPS = {
    'conv_out': {torch.ops.aten.convolution.default, torch.ops.afocus.conv3d_fwd.default},
    'skip': {torch.ops.afocus.skip_concat_fwd.default},
    'all_gather': {torch.ops._c10d_functional.all_gather_into_tensor.default,
                   torch.ops._c10d_functional.wait_tensor.default},
}


@pytest.mark.parametrize('setting', ['default', "('conv_out',)"])
def test_parity_with_selective_checkpointing(setting, micro, monkeypatch):
    """The regions with a kept set against selective checkpointing under the
    same names (:func:`sac_region`; the default keeps 'conv_in0' too): bit-equal
    gradients, and the same bytes left held by the forward."""
    def run(options):
        spec, unet, atms = skinny_models(options)
        live = LiveOutputs()
        with live:
            loss, aux = ttrain.forward(spec, unet, atms, micro)
        del aux
        held = live.live_bytes()
        loss.backward()
        return held, {f'{i}.{n}': p.grad for i, m in enumerate((unet, atms))
                      for n, p in m.named_parameters()}

    held, grads = run(SETTINGS[setting])
    monkeypatch.setattr(recompute, 'region', sac_region)
    held_ref, grads_ref = run(SETTINGS[setting])
    assert held == held_ref
    assert grads.keys() == grads_ref.keys()
    for name, g in grads.items():
        assert torch.equal(g, grads_ref[name]), name


def test_unknown_save_name_raises_as_jax():
    """An unknown decoder save name raises the JAX module's ValueError, message
    and all; 'conv_in' expands to every level."""
    bad = ('conv_out', 'conv_in9', 'conv_inn')
    kw = dict(n_views=2, num_classes=3, base_features=(2, 4, 4))
    with pytest.raises(ValueError) as ref:
        jax.eval_shape(JHybridUnet(**kw, remat_skips=False, decoder_save_names=bad).init,
                       jax.random.key(0), jnp.zeros((1, 6, 16, 16)),
                       jnp.tile(jnp.eye(4), (2, 1, 1, 1)))
    with pytest.raises(ValueError) as got:
        HybridUnet(**kw, remat_skips=False, decoder_save_names=bad)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match='conv_typo'):
        ttrain.make_models(ttrain.StageSpec(**dict(SKINNY, decoder_save_names=(
            'conv_typo',))), 'cpu')
    assert decoder_save_levels(('conv_out', 'conv_in'), 3) == {0, 1, 2}
    assert decoder_save_levels(('conv_in1',), 3) == {1}
    assert decoder_save_levels((), 3) == set()
