"""Published peaks of one NVIDIA H100 SXM (dense, 700 W) and the roofline bound:
the least time the chip could take, the larger of operations over the peak rate
and bytes over the memory bandwidth (each input read once, each output written
once)."""

PEAK_FLOPS = {'fp8': 1979e12, 'bfloat16': 989e12, 'tf32': 495e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops, nbytes, precision='bfloat16'):
    return max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)
