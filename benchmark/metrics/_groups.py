"""Device kernels by group: a frozen copy of the program's profiling table
(kernel-name substrings -> group, first match wins: the hand-written kernels
first, K4's ``wgrad_tma_kernel`` before cuDNN's ``wgrad``)."""

GROUPS = (
    ('K4 conv3d_wgrad (TMA + wgmma, + reduce)', ('wgrad_tma_kernel', 'wgrad_reduce')),
    ('K3 conv3d (TMA + wgmma; forward and as dx)', ('conv3d_tma_kernel',)),
    ('K3/K4 channels-last staging', ('channels_last_kernel',)),
    ('K1f plane_fwd', ('plane_fwd',)),
    ('K1b plane_bwd (cells, + sum)', ('plane_bwd',)),
    ('K2 volume_resample (staging, + bricks)', ('volume_resample',)),
    ('copies (cat, copy_, contiguous, casts)', ('CatArrayBatchedCopy', 'direct_copy_kernel')),
    ('cuDNN layout copies', ('nchwToNhwc', 'nhwcToNchw')),
    ('cuDNN wgrad', ('wgrad',)),
    ('cuDNN dgrad', ('dgrad',)),
    ('instance norm (cuDNN batch-norm kernels)', ('bn_', 'batch_norm', 'batchnorm')),
    ('cuDNN conv fprop', ('fprop', 'conv', 'implicit')),
    ('cuBLAS GEMM', ('gemm', 'Gemm')),
)
OTHER = 'elementwise and other'


def group_of(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return OTHER
