"""``jax.random``'s default generator in numpy, for the draws the JAX package makes at
dataset build time ('RND' base views, the centroid fit's initial parameters).

The generator is threefry2x32 with ``jax_threefry_partitionable`` on (the default
of the jax the tests run, 0.9.0): a key is two uint32 words, the counter of element
i of a draw is the (hi, lo) pair of the 64-bit flat index i, and a 32-bit draw is
the xor of the two output words. ``key``, ``split`` and ``uniform`` reproduce
``jax.random``'s bits exactly. ``normal`` is ``sqrt(2) * erfinv(u)`` on
``u ~ U(nextafter(-1, 0), 1)``, as ``jax.random.normal``, with XLA's float32
``ErfInv`` polynomial (Giles) written out as fused multiply-adds; its log1p is a
correctly rounded one, not XLA's CPU approximation, so about one draw in a hundred
is up to 3 float32 ulps (2.4e-7 relative) off JAX's (``PARITY.md``).

Keys are numpy uint32 arrays of shape (2,); nothing here needs jax.
"""

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counters (x1, x2) under the key
    (k1, k2); uint32 arrays in, two uint32 arrays out."""
    with np.errstate(over='ignore'):
        ks = (np.uint32(k1), np.uint32(k2),
              np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(shape):
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)


def key(seed):
    """``jax.random.key(seed)``'s data: the 64-bit seed's (hi, lo) words (a seed
    below 2^31 has hi 0, as jax's 32-bit seed conversion gives)."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def split(k, num=2):
    """``jax.random.split(k, num)``: (num, 2) uint32 keys."""
    b1, b2 = threefry2x32(k[0], k[1], *_counters((num,)))
    return np.stack([b1, b2], axis=-1)


def random_bits(k, shape):
    """32 random bits per element, ``jax.random.bits(k, shape, uint32)``."""
    b1, b2 = threefry2x32(k[0], k[1], *_counters(shape))
    return (b1 ^ b2).reshape(shape)


def _fma32(a, b, c):
    """float32 ``a * b + c``: the product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def uniform(k, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: the 23 high bits
    as the mantissa of a float in [1, 2), minus 1, scaled and shifted in one fused
    multiply-add (as XLA compiles it on the CPU), and held >= minval."""
    shape = tuple(shape)
    bits = random_bits(k, shape)
    floats = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): w = -log1p(-x^2),
# a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x):
    """float32 inverse error function, XLA's polynomial term for term."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide='ignore', invalid='ignore'):
        w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = _fma32(p, w, np.where(lt, np.float32(a), np.float32(b)))
        out = p * x
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out).astype(np.float32)


def normal(k, shape=()):
    """``jax.random.normal(k, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
