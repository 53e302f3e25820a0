"""The CUDA kernels on the card: each against its plain PyTorch version and
the numpy oracle, and ``backend="auto"`` resolving to them.

Marked ``cuda``: every test skips, with its reason, where no CUDA device is
available.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.switching import profile_gemm
from repro_torch.kernels.activity_profile import kernel as K
from repro_torch.kernels.activity_profile.ops import profile_gemm_toggles
from repro_torch.kernels.activity_profile.ref import profile_gemm_toggles_ref

pytestmark = pytest.mark.cuda

CASES = [
    (7, 5, 3, 32, 32, 16, 37),
    (100, 37, 29, 16, 8, 8, 20),
    (33, 70, 10, 32, 32, 16, 64),
    (2, 1, 1, 8, 8, 16, 37),
    (257, 40, 33, 16, 16, 37, 33),
    (1025, 96, 64, 32, 32, 16, 37),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _operands(case):
    rng = np.random.default_rng(list(case))
    m, k, n = case[:3]
    return rng.integers(-32767, 32768, size=(m, k)), rng.integers(-32767, 32768, size=(k, n))


@pytest.mark.parametrize("case", CASES)
def test_ws_kernel_matches_plain_and_oracle(card, case):
    a, w = _operands(case)
    a_t = torch.from_numpy(a.astype(np.int32)).to(card)
    w_t = torch.from_numpy(w.astype(np.int32)).to(card)
    before = K.ws_activity_toggles.launches
    got = K.ws_activity_toggles(a_t, w_t, *case[3:])
    torch.cuda.synchronize()
    assert K.ws_activity_toggles.launches == before + (case[0] > 1)
    assert got.tolist() == K.ws_activity_toggles_plain(a_t, w_t, *case[3:]).tolist()
    assert tuple(got.tolist()) == profile_gemm_toggles_ref(a, w, *case[3:])[:2]


@pytest.mark.parametrize("case", CASES)
def test_os_kernel_matches_oracle(card, case):
    a, w = _operands(case)
    got = profile_gemm_toggles(a, w, *case[3:], dataflow="OS", engine="cuda")
    want = profile_gemm_toggles_ref(a, w, *case[3:], dataflow="OS")
    assert (got.h_toggles, got.v_toggles, got.h_transitions, got.v_transitions) == want


def test_auto_backend_runs_the_kernels(card):
    a, w = _operands((64, 64, 48))
    before = K.ws_activity_toggles.launches
    p = profile_gemm(a, w, 32, 32, 16, 37, backend="auto", use_cache=False)
    assert K.ws_activity_toggles.launches == before + 1
    assert p == profile_gemm(a, w, 32, 32, 16, 37, backend="numpy", use_cache=False)
