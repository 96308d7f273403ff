"""Config registry of the port: the same names, aliases and ``+w4a8`` /
``+ring`` suffixes as ``repro.configs``, for all 12 of the reference's
configs (dense, MoE, RWKV6, the hybrid attention + Mamba stack, and the
cross-attention ones: llama-3.2-vision-90b's dedicated cross layers and
whisper-small's encoder-decoder). ``+ring`` (sliding-window archs only)
serves from a ring KV cache of ~window slots."""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec, shape_applicable

ARCH_IDS = ["hymba_1p5b", "llama32_vision_90b", "llama4_scout_17b_16e",
            "olmoe_1b_7b", "qwen3_8b", "h2o_danube_1p8b", "gemma_2b",
            "mistral_nemo_12b", "rwkv6_3b", "whisper_small", "llama2_7b",
            "chatglm_6b"]
# the configs every distribution cell covers (the dry run's sweep)
ASSIGNED_ARCHS = ARCH_IDS[:10]

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
            f"{name}: not ported — the port has the reference's configs "
            f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> dict[str, ModelConfig]:
    """Every config of the registry by id, in ``ARCH_IDS`` order."""
    return {a: get_config(a, reduced) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "ASSIGNED_ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "all_configs", "shape_applicable"]
