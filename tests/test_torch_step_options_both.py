"""The port's training step against the JAX package's, on the CPU in float32,
under both (whose LV index the JAX package clamps to the
foreground channel, its gradient dropped): one JAX and one torch ``train_step`` per option
from the same params and batch (``test_torch_train_step.run_step_pair``).
The options' steps are split over files so that no file's JAX compiles make it
the longest of the suite."""

import pytest

import test_torch_train_step as tts
from test_torch_train_step import few_threads  # noqa: F401 (a fixture)


@pytest.fixture(scope='module', params=['binarized_lv_only'])
def option_step_pair(request):
    return tts.run_step_pair(dict(tts.SKINNY, **tts.LABEL_OPTIONS[request.param]))


@pytest.mark.parametrize('check', ['loss', 'dice', 'updated_params', 'params_moved'])
def test_label_options_match(option_step_pair, check):
    """Under each label option, the checks of the default step at their
    tolerances. The gradient leaves are compared in
    ``test_torch_step_kinks_options.py`` with the kink branches aligned: under
    binarized labels batch seed 4 has a sample coordinate within the two
    frameworks' rounding of a voxel knot (a locnet leaf 1.15e-4 of its max off
    running free, 4.0e-5 with JAX's coordinates)."""
    tts.label_option_checks()[check](option_step_pair)
