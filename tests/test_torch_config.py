"""The port's config registry (``repro_torch.configs``) against the
reference's: every ported config, full and reduced, plain, ``+w4a8`` and
``+ring``, is field-for-field equal."""
from __future__ import annotations

import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config

NAMES = ["llama2-7b", "qwen3-8b", "llama2-7b+w4a8", "qwen3-8b+w4a8",
         "h2o-danube-1.8b", "h2o-danube-1.8b+ring", "h2o-danube-1.8b+ring+w4a8",
         "chatglm-6b", "chatglm-6b+w4a8", "gemma-2b", "mistral-nemo-12b",
         "olmoe-1b-7b", "olmoe-1b-7b+w4a8", "llama4-scout-17b-a16e",
         "llama4-scout-17b-a16e+w4a8", "rwkv6-3b", "rwkv6-3b+w4a8", "hymba-1.5b",
         "hymba-1.5b+ring", "hymba-1.5b+ring+w4a8", "whisper-small", "whisper-small+w4a8",
         "llama-3.2-vision-90b", "llama-3.2-vision-90b+w4a8"]


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
    # every reference config is ported now; a name the reference lacks raises
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("whisper-large")
    with pytest.raises(ValueError, match="sliding-window"):
        get_config("llama2-7b+ring")       # the reference rejects it too
