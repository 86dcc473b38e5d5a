"""MRXCAT phantom dataset (same label vocabulary as MMWHS; fold splits group by
phantom + time frame through the 8-char 3d-id prefix); torch port of
``acquisition_focus_tpu/data/mrxcat.py``."""

import re
from pathlib import Path

from acquisition_focus_tpu_torch.data.base_dataset import BaseDataset


class MRXCATDataset(BaseDataset):
    @staticmethod
    def get_file_id(file_path):
        name = Path(file_path).name
        patient_id, frame_idx, type_str = re.findall(
            r'phantom_(\d{3})_t(\d{3})_(.*?).nii.gz', name)[0]
        mrxcat_id = f"{int(patient_id):03d}_t{int(frame_idx):03d}"
        return mrxcat_id, (type_str == 'label')

    def extract_3d_id(self, file_id):
        return file_id[:8]

    def set_segment_fn(self, fold_idx):
        from acquisition_focus_tpu_torch.engine.segmenter import make_segment_fn
        self.segment_fn = make_segment_fn(
            self.config.get('segment_model_path'), fold_idx, num_classes=6,
            extra_permute=False, device=self.device)


def get_dataset_class(name):
    from acquisition_focus_tpu_torch.data.mmwhs import MMWHSDataset
    # 'synthetic' resolves to MMWHSDataset: the phantom writer
    # (data/synthetic.py: write_phantom_dataset) emits MMWHS-style file names
    registry = {'mmwhs': MMWHSDataset, 'mrxcat': MRXCATDataset,
                'synthetic': MMWHSDataset}
    return registry[name]
