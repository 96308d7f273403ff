"""Config registry of the port: the same names, aliases and ``+w4a8`` /
``+ring`` suffixes as ``repro.configs``. Only the dense configs whose
family is ported are here; the others raise ``NotImplementedError``."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ["qwen3_8b", "llama2_7b"]

# every architecture of the reference, so an unported one gets a clear error
_ALIAS = {
    "hymba-1.5b": "hymba_1p5b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_16e",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-8b": "qwen3_8b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "gemma-2b": "gemma_2b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-small": "whisper_small",
    "llama2-7b": "llama2_7b",
    "chatglm-6b": "chatglm_6b",
}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name.endswith("+w4a8"):
        # int4-packed projections + int8 activations and an int8 KV cache
        base = get_config(name[: -len("+w4a8")], reduced)
        return base.replace(w4a8_serve=True, name=base.name + "+w4a8")
    if name.endswith("+ring"):
        base = get_config(name[: -len("+ring")], reduced)
        if not base.window:
            raise ValueError(f"{name}: kv_ring needs a sliding-window arch")
        return base.replace(kv_ring=True, name=base.name + "+ring")
    mod_name = _ALIAS.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(
            f"{name}: not ported yet — the port has the dense configs "
            f"{ARCH_IDS}; the other families follow ROADMAP.md §1")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.REDUCED if reduced else mod.CONFIG


__all__ = ["ARCH_IDS", "ModelConfig", "get_config"]
