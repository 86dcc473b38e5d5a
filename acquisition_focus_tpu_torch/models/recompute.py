"""Recompute regions: the JAX package's rematerialization in torch.

The JAX package runs each trainable ATM view chain under ``jax.checkpoint`` and
each decoder stage under ``nn.remat``, either recomputing the whole region in
backward or, under a ``save_only_these_names`` policy, keeping only the named
activations (``checkpoint_name``) and recomputing the rest. Here a region is
``torch.utils.checkpoint`` (non-reentrant) around the same code: the forward
builds the autograd graph and drops its residuals, and backward replays the
region to rebuild them.

* ``save_ops=None``: the whole region runs again in backward, convs included.
* ``save_ops``, a set of the names below: the region keeps the outputs of its
  kept call sites and recomputes everything else from them. A region call has a
  store, active on the thread while its forward runs (where each kept call site
  of a named kind puts its output there) and while its replay runs (where each
  one hands its stored output back, in the same order, and launches nothing).
  A kept call site sits in an autograd Function that saves what its own backward
  reads in both, so the replay rebuilds the residuals of the forward's graph one
  for one. The names are the JAX package's: :data:`CONV_OUT` is ``'conv_out'``,
  the output of every convolution (:func:`conv` for cuDNN's, and K3's
  ``ops/kernels/conv3d.py::_Conv3d``); :data:`SKIP` is K1f's concat buffer
  (``ops/kernels/plane_resample.py::_PlaneResample``), which holds the JAX
  package's kept stage input, the 3D skip; :data:`COLLECTIVES` are the forward
  all-gathers of a feature-sharded stage (``parallel/collectives.py``), kept so
  that backward does not gather again. No dispatch mode runs on the step's path
  but for the op count of each region signature's first replay (:func:`region`).
* :func:`keep_residuals` around a call keeps that call's own autograd residuals
  as they are, inside a region too: the decoder's ``'conv_in{level}'`` names,
  the inputs a conv keeps for its weight gradient.

Regions hold no random draws (every generator draw of the step happens outside
them), so no RNG state is stashed; under ``torch.no_grad()`` a region is a plain
call.
"""

import contextlib
import functools
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from acquisition_focus_tpu_torch.utils import spans

CONV_OUT = frozenset({'conv_out'})
SKIP = frozenset({'skip'})
COLLECTIVES = frozenset({'all_gather'})
_KINDS = CONV_OUT | SKIP | COLLECTIVES

_local = threading.local()
# fn -> {signature: dispatcher ops of one replay}, counted on the first replay
_OPS = weakref.WeakKeyDictionary()


class _Store:
    """One region call's kept outputs in call order: filled by its forward and
    handed out again, in the same order, by its replay."""
    __slots__ = ('kinds', 'items', 'serving', 'next')

    def __init__(self, kinds):
        self.kinds, self.items, self.serving, self.next = kinds, [], False, 0


def kept(kinds, compute):
    """The output of a kept call site of ``kinds``: ``compute()``, which the
    store of a region that keeps ``kinds`` keeps in its forward; in its replay,
    the kept output, and ``compute`` does not run."""
    store = getattr(_local, 'store', None)
    if store is None or kinds.isdisjoint(store.kinds):
        return compute()
    if not store.serving:
        out = compute()
        store.items.append(out)
        return out
    out = store.items[store.next]
    store.items[store.next] = None
    store.next += 1
    spans.count('recompute.served')
    return out


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def _autocast(device_type, *tensors):
    """The casts autocast gives a convolution's floating tensors (double excepted)."""
    if not torch.is_autocast_enabled(device_type):
        return tensors
    dt = torch.get_autocast_dtype(device_type)
    return tuple(t if t is None or not t.is_floating_point()
                 or t.dtype in (dt, torch.float64) else t.to(dt) for t in tensors)


class _Convolution(torch.autograd.Function):
    """``torch.convolution`` as a kept call site: in a replay its output comes
    from the store; its gradient is ``aten.convolution_backward``, as
    ``ConvolutionBackward0`` computes it."""

    @staticmethod
    def forward(ctx, x, weight, bias, params):
        ctx.save_for_backward(x, weight)
        ctx.params = params
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        return kept(CONV_OUT, lambda: torch.convolution(x, weight, bias, *params))

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        dx, dw, db = torch.ops.aten.convolution_backward(
            grad, x, w, ctx.bias_sizes, *ctx.params, list(ctx.needs_input_grad[:3]))
        return dx, dw, db, None


def conv(x, weight, bias=None, stride=1, padding=0, dilation=1, transposed=False,
         output_padding=0, groups=1):
    """``torch.convolution`` with the casts autocast gives ``F.conv3d`` and
    ``F.conv_transpose3d`` (those calls' kernels and bits); a kept call site of
    :data:`CONV_OUT`."""
    x, weight, bias = _autocast(x.device.type, x, weight, bias)
    n = weight.ndim - 2
    params = (_ntuple(stride, n), _ntuple(padding, n), _ntuple(dilation, n), transposed,
              _ntuple(output_padding, n), groups)
    store = getattr(_local, 'store', None)
    if store is None or CONV_OUT.isdisjoint(store.kinds):
        return torch.convolution(x, weight, bias, *params)
    return _Convolution.apply(x, weight, bias, params)


def conv_module(m, x):
    """``m(x)`` for an ``nn.Conv*d`` or ``nn.ConvTranspose*d`` with zero padding,
    through :func:`conv`."""
    return conv(x, m.weight, m.bias, m.stride, m.padding, m.dilation, m.transposed,
                m.output_padding, m.groups)


class _OpCount(TorchDispatchMode):
    """Counts the dispatcher ops run while active, but ``record_function``'s and
    the detaches with which the checkpoint takes each rebuilt residual."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace != 'profiler' and func is not torch.ops.aten.detach.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _active(store, serving):
    before = getattr(_local, 'store', None)
    store.serving, store.next, _local.store = serving, 0, store
    try:
        yield
    finally:
        _local.store = before


@contextlib.contextmanager
def _replay(store, fn, sig):
    """The context of a region's replay in backward (entered only then): counts
    the replay and runs it in the span ``af.recompute``; with a kept set, with
    the store serving, and counts its ops (``recompute.ops``), under a dispatch
    mode the first time the signature replays."""
    spans.count('recompute.replays')
    if store is None:
        with spans.span('af.recompute'):
            yield
        return
    ops = _OPS.setdefault(fn, {})
    n = ops.get(sig)
    counter = _OpCount() if n is None else contextlib.nullcontext()
    with spans.span('af.recompute'), _active(store, True):
        try:
            with counter:
                yield
        finally:
            if n is None:
                n = ops[sig] = counter.n
            spans.count('recompute.ops', n)


def _contexts(kinds, fn, sig):
    store = None if kinds is None else _Store(kinds)
    forward = contextlib.nullcontext() if store is None else _active(store, False)
    return forward, _replay(store, fn, sig)


def region(fn, *args, save_ops=None):
    """``fn(*args)`` as a recompute region: everything recomputed in backward
    (``save_ops=None``), or all but the outputs of the kept call sites of the
    kinds in ``save_ops`` (module docstring).

    Each replay in backward counts ``recompute.replays`` and runs in the span
    ``af.recompute`` (``utils/spans.py``). With a kept set the replay also counts
    ``recompute.served``, each kept output handed back, and ``recompute.ops``,
    the dispatcher ops it runs again (:class:`_OpCount`): counted
    under a dispatch mode on the first replay of each signature (``fn``, the kept
    kinds and the tensor arguments' shapes and dtypes) and taken from there
    after. A replay stops once backward has what it needs, so the last ops of a
    region may not run again. A whole-region replay (``save_ops=None``) counts
    replays only."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kinds = None if save_ops is None else frozenset(save_ops)
    if kinds is not None and not kinds <= _KINDS:
        raise ValueError(f"unknown save_ops {sorted(kinds - _KINDS)}: expected names "
                         f"among {sorted(_KINDS)}")
    sig = None if kinds is None else (kinds, tuple(
        (tuple(a.shape), a.dtype) for a in args if isinstance(a, torch.Tensor)))
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=functools.partial(_contexts, kinds, fn, sig))


@contextlib.contextmanager
def keep_residuals(keep=True):
    """The autograd residuals saved inside are kept as they are (``keep``), not
    dropped for recomputation by an enclosing region."""
    if not keep:
        yield
        return
    with torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
        yield
