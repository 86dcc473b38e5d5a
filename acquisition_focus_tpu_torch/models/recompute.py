"""Recompute regions: the JAX package's rematerialization in torch.

The JAX package runs each trainable ATM view chain under ``jax.checkpoint`` and
each decoder stage under ``nn.remat``, either recomputing the whole region in
backward or, under a ``save_only_these_names`` policy, keeping only the named
activations (``checkpoint_name``) and recomputing the rest. Here a region is
``torch.utils.checkpoint`` (non-reentrant) around the same code:

* ``save_ops=None``: the whole region runs again in backward, convs included.
* ``save_ops``, a set of dispatcher ops: selective checkpointing keeps the
  outputs of those ops and recomputes everything else from them. The ops are the
  JAX package's names: :data:`CONV_OUT` is ``'conv_out'``, the output of every
  convolution (cuDNN's ``aten.convolution`` and K3's op); :data:`SKIP` is K1f's
  concat buffer, which holds the JAX package's kept stage input, the 3D skip;
  :data:`COLLECTIVES` are the forward all-gathers of a feature-sharded stage
  (``parallel/collectives.py``), kept so that backward does not gather again.
  The hand-written kernels' forwards are dispatcher ops
  (``torch.library.custom_op``) for this: a launch through ctypes inside an
  autograd Function would be invisible to the policy and run again.
* :func:`keep_residuals` around a call keeps that call's own autograd residuals
  as they are, inside a region too: the decoder's ``'conv_in{level}'`` names,
  the inputs a conv keeps for its weight gradient.

Regions hold no random draws (every generator draw of the step happens outside
them), so no RNG state is stashed; under ``torch.no_grad()`` a region is a plain
call.
"""

import contextlib
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn)

# registers the kernels' dispatcher ops named below
import acquisition_focus_tpu_torch.ops.kernels.conv3d  # noqa: F401
import acquisition_focus_tpu_torch.ops.kernels.plane_resample  # noqa: F401
from acquisition_focus_tpu_torch.parallel.collectives import KEPT_OPS, kept_gathers
from acquisition_focus_tpu_torch.utils import spans

CONV_OUT = frozenset({torch.ops.aten.convolution.default,
                      torch.ops.afocus.conv3d_fwd.default})
SKIP = frozenset({torch.ops.afocus.skip_concat_fwd.default})
COLLECTIVES = KEPT_OPS


def _policy(save_ops, tally, ctx, op, *args, **kwargs):
    if op in save_ops:
        return CheckpointPolicy.MUST_SAVE
    if not ctx.is_recompute and op.namespace != 'profiler':
        tally[0] += 1
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _replay(recompute_ctx, tally, keeps_gathers):
    """The context of a region's replay in backward (entered only then): counts
    the replay and the ops the policy marked for recomputation, and runs it in
    the span ``af.recompute``, outside the policy's dispatch mode."""
    spans.count('recompute.replays')
    if tally[0]:
        spans.count('recompute.ops', tally[0])
    with spans.span('af.recompute'), \
            kept_gathers() if keeps_gathers else contextlib.nullcontext(), recompute_ctx:
        yield


def _contexts(save_ops):
    tally = [0]
    if save_ops is None:
        forward_ctx, recompute_ctx = noop_context_fn()
    else:
        forward_ctx, recompute_ctx = create_selective_checkpoint_contexts(
            functools.partial(_policy, save_ops, tally))
    keeps_gathers = save_ops is not None and KEPT_OPS <= save_ops
    return forward_ctx, _replay(recompute_ctx, tally, keeps_gathers)


def region(fn, *args, save_ops=None):
    """``fn(*args)`` as a recompute region: everything recomputed in backward
    (``save_ops=None``), or all but the outputs of the ops in ``save_ops``.

    Each replay in backward counts ``recompute.replays`` and runs in the span
    ``af.recompute`` (``utils/spans.py``). Under the selective policy the replay
    also counts, in ``recompute.ops``, the dispatcher ops that the policy marked
    for recomputation in the forward (``record_function``'s own ops left out; a
    replay that stops early, once backward has what it needs, may leave the last
    of them unrun). A whole-region replay (``save_ops=None``) counts replays
    only: no policy sees its ops."""
    if not torch.is_grad_enabled():
        return fn(*args)
    save_ops = None if save_ops is None else frozenset(save_ops)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=functools.partial(_contexts, save_ops))


@contextlib.contextmanager
def keep_residuals(keep=True):
    """The autograd residuals saved inside are kept as they are (``keep``), not
    dropped for recomputation by an enclosing region."""
    if not keep:
        yield
        return
    with torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
        yield
