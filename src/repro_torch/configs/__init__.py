"""Model configurations (exact public configs) + reduced smoke variants.

``get_config(arch)`` -> full ModelConfig; ``get_smoke_config(arch)`` -> a
tiny same-family variant for CPU tests. The dense family
(``h2o_danube_3_4b`` with its sliding-window ring cache), the MoE family
(``qwen2_moe_a2_7b``, ``phi3_5_moe_42b``), the SSM family
(``falcon_mamba_7b``), the hybrid family (``hymba_1_5b``), the vision
family (``llama_3_2_vision_90b``: cross attention to stub patch
embeddings every fifth layer) and the audio family (``whisper_tiny``: an
encoder over stub frame embeddings, a decoder cross-attending to it) are
ported.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.common import ModelConfig

ARCH_IDS: List[str] = ["llama3_8b", "llama2_7b", "starcoder2_3b",
                       "deepseek_67b", "llama3_405b", "h2o_danube_3_4b",
                   "falcon_mamba_7b", "hymba_1_5b", "qwen2_moe_a2_7b",
                   "phi3_5_moe_42b", "llama_3_2_vision_90b", "whisper_tiny"]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise ValueError(f"{arch!r} is not ported; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
