"""Build, load and account for the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded through ``ctypes``. Nothing includes
PyTorch's headers, so the build takes seconds, not minutes. The library lands in
``build/kernels/`` at the repository root, named by a hash of the sources and flags:
a changed source builds anew, an unchanged one loads what is there.

The build happens on the first kernel launch, never at import: the CPU tests import
every module on machines without ``nvcc``. There is no fallback: a missing ``nvcc``
or a failed build raises.

Each launch adds one to the counter ``launch.<kernel>`` of ``utils/spans.py``;
``LAUNCHES`` is the per-kernel view of those counters, the launches since the
last :func:`reset_launch_counts`. K3 launched as the input gradient of the conv
counts under ``conv3d_dx``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from acquisition_focus_tpu_torch.utils import spans

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    'afk_plane_resample_fwd': [_P, _P, _P, _L] + [_I] * 7 + [_P],
    'afk_plane_resample_bwd': [_P, _P, _P, _L, _I, _P, _P, _P] + [_I] * 6 + [_P],
    'afk_volume_resample': [_P] * 4 + [_I] * 10 + [_P],
    'afk_conv3d_fwd': [_P] * 5 + [_I] * 8 + [_P],
    'afk_conv3d_wgrad_workspace': [_I] * 6 + [_P],
    'afk_conv3d_wgrad': [_P] * 5 + [_I] * 7 + [_P],
    'afk_p2v_rows': [_I] * 7,
    'afk_p2v_merge_fwd': [_P] * 8 + [_I] * 7 + [_F, _P],
    'afk_p2v_merge_dx': [_P] * 3 + [_I] * 6 + [_P],
    'afk_p2v_merge_dw': [_P] * 6 + [_I] * 7 + [_F, _P],
    'afk_p2v_merge_norm': [_P] * 8 + [_I] * 6 + [_F, _P],
    'afk_p2v_merge_sum': [_P] + [_I] * 4 + [_P] * 4 + [_L, _F, _P],
    'afk_p2v_up_dw': [_P] * 3 + [_I] * 4 + [_P],
}

LAUNCHES = spans.CounterView('launch.', (
    'plane_resample_fwd', 'plane_resample_bwd', 'volume_resample', 'conv3d_fwd',
    'conv3d_dx', 'conv3d_wgrad', 'p2v_merge_fwd', 'p2v_merge_dx', 'p2v_merge_dw',
    'p2v_merge_norm', 'p2v_merge_sum', 'p2v_up_dw'))

_lib = None


def reset_launch_counts():
    LAUNCHES.reset()


def _nvcc():
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and (Path(cand) / 'bin' / 'nvcc').is_file():
            return str(Path(cand) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the "
                           "CUDA kernels cannot be built")
    return found


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob('*.cu'))
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode() + path.read_bytes())
    target = BUILD_DIR / f'libafocus_kernels_{digest.hexdigest()[:16]}.so'
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.afk_plane_resample_bwd_workspace.argtypes = [_I] * 4
    lib.afk_plane_resample_bwd_workspace.restype = ctypes.c_longlong
    lib.afk_error_string.argtypes = [ctypes.c_int]
    lib.afk_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch(kernel, fn_name, *args):
    """Call C entry ``fn_name`` of the library on the current CUDA stream, raise
    on a launch error, and count one launch of ``kernel``."""
    import torch
    if kernel not in LAUNCHES:
        raise KeyError(f"no launch counter for kernel {kernel!r}")
    fn = getattr(library(), fn_name)
    # ctypes passes arguments beyond argtypes unconverted, so a wrong count
    # would not raise by itself
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"{fn_name} takes {len(fn.argtypes) - 1} arguments and the "
                        f"stream, got {len(args)}")
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({library().afk_error_string(rc).decode()})")
    spans.count('launch.' + kernel)


def check_cuda_tensor(name, t, dtypes=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of an accepted dtype."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
