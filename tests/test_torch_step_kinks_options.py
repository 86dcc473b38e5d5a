"""The port's training-step gradients against the JAX package's with the kink
branches aligned (``test_torch_step_kinks.py``), under the label options of the
shipped configs."""

import pytest

from test_torch_step_kinks import _check_aligned, _instrumented
from test_torch_train_step import (  # noqa: F401 (few_threads: a fixture)
    BATCH_SEED, LABEL_OPTIONS, SKINNY, few_threads)


@pytest.fixture(params=list(LABEL_OPTIONS))
def option_setup(request):
    yield from _instrumented(dict(SKINNY, **LABEL_OPTIONS[request.param]))


def test_label_option_grads_match_with_kink_branches_aligned(option_setup):
    """Binarized labels, the LV-only loss and both, on the batch of
    ``test_torch_train_step.py``."""
    _check_aligned(option_setup, BATCH_SEED)
