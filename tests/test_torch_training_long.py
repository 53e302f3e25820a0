"""The port's loss and gradients against the JAX package's at S = 128,
past the reduced ``attn_chunk`` (64: blockwise attention, whose output the
port writes chunk by chunk into one tensor) and across several Mamba and
xLSTM scan chunks (``scan_chunk`` 16), plus that half of the committed
``train_reference.json``.  Tolerances are ``test_torch_training.py``'s
(``GRAD_RTOL``, ``METRIC_RTOL``, ``FILE_TOL``); it is a file of its own so
that the JAX package's compiles at this length run beside those at S = 32.
"""

import pytest
import torch
from _torch_reference import TRAIN
from test_torch_training import ARCH_IDS, check_file_part, check_loss_and_grads


@pytest.fixture(autouse=True)
def _few_threads():
    """As in ``test_torch_training.py``: two torch threads in this worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference_at_128(arch):
    check_loss_and_grads(arch, TRAIN["long_seq"], 1)


def test_train_reference_file_is_current_at_128():
    check_file_part("long")
