"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Every assigned architecture has a module with ``config()`` (the exact
published configuration) and ``reduced()`` (a tiny same-family config for CPU
smoke tests).  ``enet`` is the paper's own workload.

The port's own copy of ``repro.configs``: the same ids and the same
published and reduced configurations, as data only.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "whisper-small": "repro_torch.configs.whisper_small",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).config()


def get_reduced(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).reduced()
