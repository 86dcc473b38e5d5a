"""Channel-axis (axis 1) reductions for (B, C, *spatial) tensors (torch port of
``acquisition_focus_tpu/ops/channel_ops.py``).

The JAX package unrolls these into C - 1 elementwise passes because XLA:TPU
lowers strided channel reductions slowly; the port keeps the same unrolled
arithmetic, so its sums add the channels in the same order (``channel_sum`` of
float32 values equals the JAX package's bit for bit). Semantics match the
torch equivalents (argmax: first maximum wins).
"""

import torch


def channel_max(x, keepdims=True):
    """max over axis 1, unrolled."""
    m = x[:, 0]
    for c in range(1, x.shape[1]):
        m = torch.maximum(m, x[:, c])
    return m[:, None] if keepdims else m


def channel_sum(x, keepdims=True):
    """sum over axis 1, unrolled (channel 0 first)."""
    s = x[:, 0]
    for c in range(1, x.shape[1]):
        s = s + x[:, c]
    return s[:, None] if keepdims else s


def channel_softmax(x):
    """softmax over axis 1 (shifted by the channel max), unrolled reductions."""
    e = torch.exp(x - channel_max(x))
    return e / channel_sum(e)


def channel_log_softmax(x):
    """log_softmax over axis 1, unrolled reductions."""
    y = x - channel_max(x)
    return y - torch.log(channel_sum(torch.exp(y)))


def channel_argmax(x):
    """argmax over axis 1 (first maximum wins), int64."""
    m = x[:, 0]
    idx = torch.zeros(m.shape, dtype=torch.int64, device=x.device)
    for c in range(1, x.shape[1]):
        better = x[:, c] > m
        m = torch.where(better, x[:, c], m)
        idx = torch.where(better, c, idx)
    return idx
