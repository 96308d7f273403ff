"""The port's agreement rate of continuous against lock-step ``+w4a8``
serving equals the reference's
(``tests/test_serving_conformance.py::test_w4a8_agreement_floor_vs_lockstep``,
whose ``W4A8_AGREEMENT_FLOORS`` list 7 variants): the dense and MoE
variants here, the cross-attention ones in
``tests/test_torch_agreement_xattn.py``, the ring ones in
``tests/test_torch_agreement_ring.py`` (split to keep each file under a
minute on one worker). The check: ``tests/_torch_agreement.py``."""
from __future__ import annotations

import pytest
import torch

from _torch_agreement import check_agreement

VARIANTS = ['qwen3_8b+w4a8', 'llama2_7b+w4a8', 'llama4_scout_17b_16e+w4a8']


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
