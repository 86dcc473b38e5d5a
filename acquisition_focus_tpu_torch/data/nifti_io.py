"""The port's own copy of the JAX package's ``data/nifti_io.py`` (plain numpy; tests
hold the files it writes and the arrays it reads equal to the original's).

Minimal, dependency-free NIfTI-1 reader/writer (.nii / .nii.gz).

The deployment image has no nibabel; the format is simple enough to own. Arrays are
returned indexed (i, j, k) with i fastest in memory (Fortran layout), matching what
``nibabel.load(...).get_fdata()`` produces, so the rest of the pipeline is agnostic
to which loader produced the data. The affine maps (i, j, k, 1) -> RAS+ mm, taken
from the sform when valid, else the qform quaternion, else pixdim scaling.
"""

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path, mode):
    path = Path(path)
    if path.suffix == '.gz':
        return gzip.open(path, mode)
    return open(path, mode)


def _qform_affine(hdr):
    b, c, d = hdr['quatern_b'], hdr['quatern_c'], hdr['quatern_d']
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    r = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    qfac = -1.0 if hdr['pixdim'][0] < 0 else 1.0
    zooms = np.array([hdr['pixdim'][1], hdr['pixdim'][2], qfac * hdr['pixdim'][3]])
    aff = np.eye(4)
    aff[:3, :3] = r * zooms[None, :]
    aff[:3, 3] = [hdr['qoffset_x'], hdr['qoffset_y'], hdr['qoffset_z']]
    return aff


def _parse_header(raw):
    if len(raw) < 348:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack_from('<i', raw, 0)[0]
    endian = '<'
    if sizeof_hdr != 348:
        endian = '>'
        if struct.unpack_from('>i', raw, 0)[0] != 348:
            raise ValueError("not a NIfTI-1 file")
    u = lambda fmt, off: struct.unpack_from(endian + fmt, raw, off)
    hdr = {
        'dim': u('8h', 40),
        'datatype': u('h', 70)[0],
        'bitpix': u('h', 72)[0],
        'pixdim': u('8f', 76),
        'vox_offset': u('f', 108)[0],
        'scl_slope': u('f', 112)[0],
        'scl_inter': u('f', 116)[0],
        'qform_code': u('h', 252)[0],
        'sform_code': u('h', 254)[0],
        'quatern_b': u('f', 256)[0],
        'quatern_c': u('f', 260)[0],
        'quatern_d': u('f', 264)[0],
        'qoffset_x': u('f', 268)[0],
        'qoffset_y': u('f', 272)[0],
        'qoffset_z': u('f', 276)[0],
        'srow_x': u('4f', 280),
        'srow_y': u('4f', 296),
        'srow_z': u('4f', 312),
        'magic': raw[344:348],
        'endian': endian,
    }
    return hdr


def load_nifti(path, dtype=None):
    """Load a .nii/.nii.gz file.

    Returns (data, affine): data indexed (i, j, k[, t...]) matching nibabel's
    ``get_fdata`` layout; affine (4, 4) float64 vox->RAS+.
    """
    with _open(path, 'rb') as f:
        raw = f.read()
    hdr = _parse_header(raw)

    ndim = hdr['dim'][0]
    shape = tuple(hdr['dim'][1:1 + ndim])
    np_dtype = np.dtype(_DTYPES[hdr['datatype']]).newbyteorder(hdr['endian'])
    offset = int(hdr['vox_offset'])
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=offset)
    data = data.reshape(shape, order='F')

    slope, inter = hdr['scl_slope'], hdr['scl_inter']
    if slope not in (0.0, 1.0) or inter not in (0.0,):
        if slope == 0.0:
            slope = 1.0
        data = data * slope + inter

    if hdr['sform_code'] > 0:
        affine = np.array([hdr['srow_x'], hdr['srow_y'], hdr['srow_z'],
                           [0, 0, 0, 1]], dtype=np.float64)
    elif hdr['qform_code'] > 0:
        affine = _qform_affine(hdr)
    else:
        affine = np.diag(list(hdr['pixdim'][1:4]) + [1.0]).astype(np.float64)

    if dtype is not None:
        data = data.astype(dtype)
    return np.asarray(data), affine


def save_nifti(path, data, affine):
    """Write data (i, j, k indexed) + affine as a single-file NIfTI-1 (.nii/.nii.gz)."""
    data = np.asarray(data)
    affine = np.asarray(affine, np.float64)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)

    hdr = bytearray(352)  # 348 header + 4 pad to vox_offset 352
    struct.pack_into('<i', hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into('<8h', hdr, 40, *dims)
    struct.pack_into('<h', hdr, 70, _DTYPE_CODES[data.dtype])
    struct.pack_into('<h', hdr, 72, data.dtype.itemsize * 8)
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(0))
    struct.pack_into('<8f', hdr, 76, 1.0, *zooms, *([1.0] * (7 - 3)))
    struct.pack_into('<f', hdr, 108, 352.0)
    struct.pack_into('<f', hdr, 112, 1.0)  # scl_slope
    struct.pack_into('<h', hdr, 252, 0)    # qform unused
    struct.pack_into('<h', hdr, 254, 1)    # sform aligned
    struct.pack_into('<4f', hdr, 280, *affine[0])
    struct.pack_into('<4f', hdr, 296, *affine[1])
    struct.pack_into('<4f', hdr, 312, *affine[2])
    hdr[344:348] = b'n+1\x00'

    with _open(path, 'wb') as f:
        f.write(bytes(hdr))
        f.write(np.asfortranarray(data).tobytes(order='F'))
