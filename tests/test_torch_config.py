"""The port's config registry (``repro_torch.configs``) against the
reference's: every ported config, full and reduced, plain and ``+w4a8``, is
field-for-field equal."""
from __future__ import annotations

import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config

NAMES = ["llama2-7b", "qwen3-8b", "llama2-7b+w4a8", "qwen3-8b+w4a8"]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_config_field_equal(name, reduced):
    got = dataclasses.asdict(get_config(name, reduced))
    want = dataclasses.asdict(jax_get_config(name, reduced))
    assert got == want


def test_config_properties_equal():
    for name in NAMES:
        a, b = get_config(name), jax_get_config(name)
        assert (a.resolved_head_dim, a.rotary_dim) == (b.resolved_head_dim, b.rotary_dim)


def test_unported_and_invalid_configs_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("rwkv6-3b")
    with pytest.raises(ValueError, match="sliding-window"):
        get_config("llama2-7b+ring")       # the reference rejects it too
