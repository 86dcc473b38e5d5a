"""Are the port's bf16 gradients and their dependence on the batch's layout the JAX
package's? On the CPU, from one set of flax params (``convert.py``) and one
numpy-seeded batch, each package's first-microbatch gradient of its
``train_step`` path (the loss over ``num_grad_accum_steps``, as the step forms
it) in four runs:

  (a) bf16 on the whole batch;    (b) float32 on the whole batch;
  (c) bf16 as the mean of the batch's two halves' gradients (the layout of a
      {'data': 2} mesh, as ``scripts/smoke_mesh.first_grads(..., blocks=2)``
      takes it);                  (d) the same as (c) in float32.

The spec is ``test_torch_mesh.py``'s PORT_SPEC (three U-Net levels at 16^3, 3
views, the locnets at a 32^3 prescan, batch 4, view 1 training, view 0 frozen,
view 2 inactive) with ``compute_dtype`` bf16, where PR 10's CPU rehearsal of
``smoke_mesh`` showed one device's bf16 gradients 2.3x of a leaf's max from
float32; with augmentation off, since the two packages draw from different
generators (so each half has its rows' draws: none). Each distance is the
largest |difference| of a leaf over the leaf's max (the pre-norm conv biases,
whose exact gradient is 0: over the largest leaf's max), per family: the ATM
heads (``atms.*.locnet.dense``), the locnets' convolutions and the U-Net.

The decision (``acquisition_focus_tpu_torch/PARITY.md``, "bf16 gradients"): the
gap is the reference's own behaviour. The port's worst leaf of each family
stays within twice the JAX package's for |a - b| and |a - c|; for |b - d|, which
both packages hold at float32 rounding, within twice JAX's or 1e-5, JAX's own
relative mesh bound (``tests/test_parallel.py``).
"""

import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from acquisition_focus_tpu.engine import train as jtrain
from acquisition_focus_tpu_torch.convert import (
    atm_state_dicts, load_flax_params, unet_state_dict)
from acquisition_focus_tpu_torch.engine import train as ttrain
from acquisition_focus_tpu_torch.scripts.smoke_mesh import first_grads

from test_torch_mesh import PORT_SPEC, port_batch
from test_torch_train_step import is_pre_norm_bias

SPEC = dict(PORT_SPEC, augment_input=False, augment_recon=False)
FAMILIES = ('atm_heads', 'locnets', 'unet')
DISTANCES = ('a-b', 'a-c', 'b-d')
ROUNDING = 1e-5          # |b - d|: float32 rounding, JAX's relative mesh bound


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def family(name):
    if name.startswith('unet.'):
        return 'unet'
    return 'atm_heads' if '.locnet.dense.' in name else 'locnets'


def named(grads):
    """JAX (unet, atm) gradient trees -> {port name: tensor}."""
    out = {f'unet.{k}': v for k, v in unet_state_dict(grads[0]).items()}
    for v, sd in enumerate(atm_state_dicts(grads[1])):
        out.update({f'atms.{v}.{k}': t for k, t in sd.items()})
    return out


def jax_grads(params, micro, dtype):
    """The JAX package's whole-batch and halves-mean first-microbatch gradients,
    from one compile (the halves mapped over with ``lax.map``)."""
    spec = jtrain.StageSpec(**dict(SPEC, compute_dtype=dtype))
    unet, atms = jtrain.make_models(spec)
    accum = spec.num_grad_accum_steps

    def loss(p, m):
        return jtrain.forward(spec, unet, p[0], atms, p[1], m, None, train=True)[0] / accum

    grad = jax.grad(loss)

    @jax.jit
    def both(p, m):
        B = m['label'].shape[0]
        halves = {k: (jnp.stack([v[:, :B // 2], v[:, B // 2:]]) if k == 'view_affines'
                      else v.reshape((2, B // 2) + v.shape[1:])) for k, v in m.items()}
        mean = jax.tree_util.tree_map(lambda g: g.mean(0),
                                      jax.lax.map(lambda h: grad(p, h), halves))
        return grad(p, m), mean

    whole, halves = both(params, {k: jnp.asarray(v) for k, v in micro.items()})
    return tuple(named(jax.tree_util.tree_map(np.asarray, g)) for g in (whole, halves))


def port_grads(params, batch, dtype, blocks):
    spec = ttrain.StageSpec(**dict(SPEC, compute_dtype=dtype))
    unet, atms = ttrain.make_models(spec, 'cpu')
    load_flax_params(unet, atms, *params)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    return first_grads(spec, unet, atms, tb, None, blocks)


def worst(got, ref):
    """{family: (largest leaf distance over its scale, leaf)}."""
    top = max(float(np.abs(np.asarray(r, np.float64)).max()) for r in ref.values())
    out = {}
    for name, r in ref.items():
        r = np.asarray(r, np.float64)
        scale = top if is_pre_norm_bias(name) else max(float(np.abs(r).max()), 1e-30)
        d = float(np.abs(np.asarray(got[name], np.float64) - r).max()) / scale
        out[family(name)] = max(out.get(family(name), (0.0, '')), (d, name))
    return out


@pytest.fixture(scope='module')
def distances():
    """{package: {distance: {family: (value, leaf)}}}. The two JAX compiles run in
    threads beside the port's four runs."""
    batch = port_batch()
    micro = {k: np.asarray(v[0]) for k, v in batch.items()}
    params = jax.tree_util.tree_map(
        np.array, jtrain.init_params(jtrain.StageSpec(**SPEC), jax.random.key(0)))
    jax_runs = {}
    threads = [threading.Thread(target=lambda dt=dt: jax_runs.update(
        {dt: jax_grads(params, micro, dt)})) for dt in ('bfloat16', 'float32')]
    for t in threads:
        t.start()
    port = {(dt, blocks): port_grads(params, batch, dt, blocks)
            for dt in ('bfloat16', 'float32') for blocks in (1, 2)}
    for t in threads:
        t.join()
    runs = {'jax': dict(a=jax_runs['bfloat16'][0], b=jax_runs['float32'][0],
                        c=jax_runs['bfloat16'][1], d=jax_runs['float32'][1]),
            'port': dict(a=port['bfloat16', 1], b=port['float32', 1],
                         c=port['bfloat16', 2], d=port['float32', 2])}
    out = {}
    for pkg, r in runs.items():
        assert r['a'].keys() == r['b'].keys() == r['c'].keys() == r['d'].keys()
        out[pkg] = {'a-b': worst(r['a'], r['b']), 'a-c': worst(r['a'], r['c']),
                    'b-d': worst(r['b'], r['d'])}
    print({p: {d: {f: f'{v:.3e} ({leaf})' for f, (v, leaf) in fam.items()}
               for d, fam in ds.items()} for p, ds in out.items()})
    return out


@pytest.mark.parametrize('fam', FAMILIES)
@pytest.mark.parametrize('dist', DISTANCES)
def test_port_gap_is_within_twice_the_reference(distances, dist, fam):
    port, ref = distances['port'][dist][fam][0], distances['jax'][dist][fam][0]
    allowed = 2.0 * ref if dist != 'b-d' else max(2.0 * ref, ROUNDING)
    assert port <= allowed, (dist, fam, distances['port'][dist][fam],
                             distances['jax'][dist][fam])
    if dist == 'a-b':       # the gap is real in both packages: bf16 is not float32
        assert ref > 0.05 and port > 0.05, (distances['port'][dist][fam], ref)
