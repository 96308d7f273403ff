"""Agreement parity (``tests/_torch_agreement.py``) of the ring ``+w4a8``
variants of the reference's ``W4A8_AGREEMENT_FLOORS``, hymba-1.5b's
among them (one of the two whose floors the reference breaches under jax
0.9.0, with llama4-scout's in ``tests/test_torch_agreement.py``)."""
from __future__ import annotations

import pytest
import torch

from _torch_agreement import check_agreement

VARIANTS = ['h2o_danube_1p8b+ring+w4a8', 'hymba_1p5b+ring+w4a8']


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
