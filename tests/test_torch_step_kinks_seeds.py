"""The port's training-step gradients against the JAX package's with the kink
branches aligned (``test_torch_step_kinks.py``), on batch seeds 5-9."""

import pytest

from test_torch_step_kinks import _check_aligned, setup  # noqa: F401 (a fixture)
from test_torch_train_step import few_threads  # noqa: F401 (a fixture)


@pytest.mark.parametrize('seed', range(5, 10))
def test_grads_match_with_kink_branches_aligned(setup, seed):  # noqa: F811
    _check_aligned(setup, seed)
