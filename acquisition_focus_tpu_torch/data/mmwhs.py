"""MMWHS dataset (MRI whole-heart, classes background/MYO/LV/RV/LA/RA); torch port of
``acquisition_focus_tpu/data/mmwhs.py``."""

import re
from pathlib import Path

from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset


def refuse_segmenter(config):
    """The from-segmented segmenter is not ported: a configured one raises."""
    if config.get('segment_model_path'):
        raise NotImplementedError(
            "not ported yet: segment_model_path (the from-segmented segmenter)")


class MMWHSDataset(BaseDataset):
    @staticmethod
    def get_file_id(file_path):
        name = Path(file_path).name
        modality, patient_id, type_str = re.findall(
            r'(ct|mr)_.*_(\d{4})_(.*?).nii.gz', name)[0]
        mmwhs_id = f"{modality}_{int(patient_id):04d}"
        return mmwhs_id, ('label' in type_str)

    def set_segment_fn(self, fold_idx):
        refuse_segmenter(self.config)
        self.segment_fn = None
