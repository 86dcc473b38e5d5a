"""Convert an orbax checkpoint directory of the JAX package into the port's
``torch.save`` file: a run checkpoint (params, both optimizer states, epoch,
loss, best quality) for ``model_checkpoint_path`` /
``transform_model_checkpoint_path``, or a segmenter checkpoint for
``segment_model_path`` (``engine/orbax_import.py``).

    python -m acquisition_focus_tpu_torch.scripts.import_orbax SRC DST

Needs ``tensorstore`` (not jax or orbax); the file it writes needs neither.
"""

import argparse

from acquisition_focus_tpu_torch.engine.checkpoint import save_checkpoint
from acquisition_focus_tpu_torch.engine.orbax_import import import_checkpoint


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('src', help="the JAX package's orbax checkpoint directory")
    parser.add_argument('dst', help="the port's checkpoint file to write")
    args = parser.parse_args(argv)
    save_checkpoint(args.dst, import_checkpoint(args.src))
    print(f"wrote {args.dst}")


if __name__ == '__main__':
    main()
