"""Tests of the benchmark: CPU at small sizes; tests that need the card carry the
``cuda`` marker and skip inside the test where there is none."""

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]

# the small shapes of the CPU tests: 32^3 at 1.5 mm, narrow widths
SMALL = dict(hires_fov_mm=[48.0] * 3, hires_fov_vox=[32] * 3, slice_fov_mm=[48.0, 48.0, 1.5],
             slice_fov_vox=[32, 32, 1], prescan_fov_mm=[48.0] * 3, prescan_fov_vox=[32] * 3,
             base_features=[2, 4, 4, 8], locnet_width=2)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def small_root(tmp_path):
    """A checkout-like root: BENCHMARK.json and the benchmark's data files, the
    hybrid U-Net configuration at the small shapes (float32 convs, so that the
    program and the reference agree to rounding on the CPU)."""
    root = tmp_path / 'root'
    (root / 'benchmark').mkdir(parents=True)
    shutil.copy(REPO / 'BENCHMARK.json', root / 'BENCHMARK.json')
    for d in ('configs', 'traffic', 'metrics', 'limits'):
        shutil.copytree(REPO / 'benchmark' / d, root / 'benchmark' / d)
    path = root / 'benchmark' / 'configs' / 'hybrid_unet_mmwhs.json'
    cfg = json.loads(path.read_text())
    cfg['config'].update(SMALL, compute_dtype='float32')
    path.write_text(json.dumps(cfg))
    torch.set_num_threads(4)
    return root
