"""Assigned-architecture registry: ``get_config(arch_id)`` and per-arch
reduced smoke configs (``get_smoke_config``).  One module per architecture,
each holding the exact published configuration from the assignment.

Port of ``repro.configs``: the same ten modules, copied verbatim apart
from the import of ``ModelConfig``, which comes from
``repro_torch.models.config``.  Only the dense archs (qwen1_5_32b,
yi_34b, granite_34b, codeqwen1_5_7b) run in ``repro_torch.models.lm``
yet; every config builds and counts its parameters."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "paligemma_3b",
    "mixtral_8x7b",
    "deepseek_v2_236b",
    "qwen1_5_32b",
    "granite_34b",
    "codeqwen1_5_7b",
    "yi_34b",
    "musicgen_medium",
    "xlstm_125m",
    "jamba_v0_1_52b",
)

_ALIASES = {
    "paligemma-3b": "paligemma_3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen1.5-32b": "qwen1_5_32b",
    "granite-34b": "granite_34b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "yi-34b": "yi_34b",
    "musicgen-medium": "musicgen_medium",
    "xlstm-125m": "xlstm_125m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def canonical(arch_id: str) -> str:
    return _ALIASES.get(arch_id, arch_id)


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.smoke_config()


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
