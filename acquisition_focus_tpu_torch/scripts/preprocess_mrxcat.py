"""MRXCAT phantom preparation CLI (the port's twin of ``scripts/preprocess_mrxcat.py``):

    python -m acquisition_focus_tpu_torch.scripts.preprocess_mrxcat \
        --raw_dir <phantoms> --out_dir <prepared> [--device cpu]

Expects per-frame files phantom_XXX_tYYY_{image,label}.nii.gz. Resamples and crops
on the card unless ``--device cpu`` is given.
"""
import argparse
import re
from pathlib import Path

from acquisition_focus_tpu_torch.data.preprocess import (
    MRXCAT_LABEL_MAP, preprocess_case, write_data_split)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--raw_dir', required=True)
    p.add_argument('--out_dir', required=True)
    p.add_argument('--test_phantoms', nargs='*', type=int, default=[],
                   help='phantom ids held out as test')
    p.add_argument('--num_folds', type=int, default=3)
    p.add_argument('--device', default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    raw = Path(args.raw_dir)
    images = sorted(raw.glob('phantom_*_image.nii.gz'))
    train_files, test_files = [], []
    for img_path in images:
        pid, frame = re.findall(r'phantom_(\d{3})_t(\d{3})_image', img_path.name)[0]
        lbl_path = raw / img_path.name.replace('_image', '_label')
        if not lbl_path.exists():
            continue
        stem = f'phantom_{pid}_t{frame}'
        img_name, lbl_name = preprocess_case(
            img_path, lbl_path, args.out_dir, stem, label_map=MRXCAT_LABEL_MAP,
            device=args.device)
        bucket = test_files if int(pid) in args.test_phantoms else train_files
        bucket += [img_name, lbl_name]
        print(f'prepared {stem}')
    write_data_split(args.out_dir, train_files, test_files, args.num_folds)


if __name__ == '__main__':
    main()
