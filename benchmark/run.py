"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the cell
asks for. It prints as its last line one JSON object: ``correct``, ``attempted``
and ``failed`` (steps of the window, and those whose loss was not finite),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number of the comparison with the reference beside its limit (also the last
lines on standard error). Without enough CUDA devices, or when the program
cannot be imported, or when JAX or the JAX package was loaded, it exits with a
code other than 0 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one process with few host threads: the U-Net cells are host-bound, and idle
# intra-op threads of a shared host spread their runs
HOST_THREADS = 2
os.environ['OMP_NUM_THREADS'] = str(HOST_THREADS)
# every build and kernel cache at a fixed path inside the checkout; nothing of JAX
os.environ['TRITON_CACHE_DIR'] = str(ROOT / 'build' / 'triton_cache')
os.environ['TORCH_EXTENSIONS_DIR'] = str(ROOT / 'build' / 'torch_extensions')
os.environ['USE_FLAX'] = '0'
os.environ['USE_JAX'] = '0'
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(HOST_THREADS)
    from benchmark import harness
    cell = harness.load_cell(ROOT, args.workload)
    chips = int(cell.entry['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              'cuda', T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad[:10]}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
