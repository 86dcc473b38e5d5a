"""MMWHS offline preparation CLI (the port's twin of ``scripts/preprocess_mmwhs.py``):

    python -m acquisition_focus_tpu_torch.scripts.preprocess_mmwhs \
        --raw_dir <mr_train dir> --out_dir <prepared> [--device cpu]

Resamples and crops on the card unless ``--device cpu`` is given.
"""
import argparse
import re
from pathlib import Path

from acquisition_focus_tpu_torch.data.preprocess import (
    MMWHS_LABEL_MAP, preprocess_case, write_data_split)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--raw_dir', required=True)
    p.add_argument('--out_dir', required=True)
    p.add_argument('--test_ids', nargs='*', type=int, default=[1007, 1008],
                   help='cases held out as test')
    p.add_argument('--num_folds', type=int, default=3)
    p.add_argument('--device', default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    raw = Path(args.raw_dir)
    images = sorted(raw.glob('mr_train_*_image.nii.gz'))
    train_files, test_files = [], []
    for img_path in images:
        case = int(re.findall(r'_(\d{4})_image', img_path.name)[0])
        lbl_path = raw / img_path.name.replace('_image', '_label')
        if not lbl_path.exists():
            print(f'skip {img_path.name}: no label')
            continue
        stem = f'mr_train_{case:04d}'
        img_name, lbl_name = preprocess_case(
            img_path, lbl_path, args.out_dir, stem, label_map=MMWHS_LABEL_MAP,
            device=args.device)
        bucket = test_files if case in args.test_ids else train_files
        bucket += [img_name, lbl_name]
        print(f'prepared {stem}')
    write_data_split(args.out_dir, train_files, test_files, args.num_folds)
    print(f'{len(train_files)//2} train / {len(test_files)//2} test cases')


if __name__ == '__main__':
    main()
