"""Agreement parity (``tests/_torch_agreement.py``) of the cross-attention
``+w4a8`` variants of the reference's ``W4A8_AGREEMENT_FLOORS``."""
from __future__ import annotations

import pytest
import torch

from _torch_agreement import check_agreement

VARIANTS = ['whisper_small+w4a8', 'llama32_vision_90b+w4a8']


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", VARIANTS)
def test_agreement_rate_equals_the_reference(arch):
    check_agreement(arch)
