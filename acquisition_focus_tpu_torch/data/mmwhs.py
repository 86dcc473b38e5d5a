"""MMWHS dataset (MRI whole-heart, classes background/MYO/LV/RV/LA/RA); torch port of
``acquisition_focus_tpu/data/mmwhs.py``."""

import re
from pathlib import Path

from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset


class MMWHSDataset(BaseDataset):
    @staticmethod
    def get_file_id(file_path):
        name = Path(file_path).name
        modality, patient_id, type_str = re.findall(
            r'(ct|mr)_.*_(\d{4})_(.*?).nii.gz', name)[0]
        mmwhs_id = f"{modality}_{int(patient_id):04d}"
        return mmwhs_id, ('label' in type_str)

    def set_segment_fn(self, fold_idx):
        from acquisition_focus_tpu_torch.engine.segmenter import make_segment_fn
        # extra_permute defaults True: the reference's MMWHS axis workaround for
        # its external nnU-Net checkpoints. In-framework segmenters
        # (scripts/train_segmenter.py) share this package's axis convention and
        # need no permute: set segment_extra_permute=false.
        self.segment_fn = make_segment_fn(
            self.config.get('segment_model_path'), fold_idx, num_classes=6,
            extra_permute=bool(self.config.get('segment_extra_permute', True)),
            device=self.device)
