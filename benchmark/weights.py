"""Weights from ``--seed``, made on the device in one draw, handed alike to the
program under test and to the reference.

Each parameter has a kind from the reference's initialization table: 'zeros',
'ones', 'normal' (std) or 'trunc_normal' (std, truncated at +-2 std). One
``torch.rand`` call on a generator of the device, seeded with ``seed``, gives the
uniform draws of every random leaf in the table's order; the inverse normal
distribution function turns them into normals. The same seed on the same device
gives the same weights.
"""

import math

import torch

_LO, _HI = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), 0.5 * math.erfc(-2.0 / math.sqrt(2.0))


def make_weights(kinds, shapes, seed, device):
    """{name: float32 tensor of ``shapes[name]``} on ``device``, for every name of
    ``kinds`` ({name: (kind, std)}), in its order."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    random = [n for n, (kind, _) in kinds.items() if kind in ('normal', 'trunc_normal')]
    total = sum(math.prod(shapes[n]) for n in random)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, (kind, std) in kinds.items():
        shape = tuple(shapes[name])
        if kind == 'zeros':
            out[name] = torch.zeros(shape, device=device)
        elif kind == 'ones':
            out[name] = torch.ones(shape, device=device)
        elif kind in ('normal', 'trunc_normal'):
            n = math.prod(shape)
            v = u[offset:offset + n]
            offset += n
            if kind == 'trunc_normal':
                v = _LO + v * (_HI - _LO)
            v = v.clamp(1e-7, 1.0 - 1e-7)
            out[name] = (math.sqrt(2.0) * torch.erfinv(2.0 * v - 1.0) * std).reshape(shape)
        else:
            raise ValueError(f"unknown initialization {kind!r} of {name}")
    return out


def load_into(weights, named_modules):
    """Copy ``weights`` into the parameters of ``named_modules`` ({prefix: module});
    every parameter must have a weight and every weight a parameter."""
    params = {f'{prefix}.{n}': p for prefix, m in named_modules.items()
              for n, p in m.named_parameters()}
    missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
    if missing or extra:
        raise ValueError(f"weights do not fit the model: missing {missing[:5]}, "
                         f"unknown {extra[:5]}")
    with torch.no_grad():
        for n, p in params.items():
            if tuple(p.shape) != tuple(weights[n].shape):
                raise ValueError(f"{n}: {tuple(p.shape)} against {tuple(weights[n].shape)}")
            p.copy_(weights[n])
