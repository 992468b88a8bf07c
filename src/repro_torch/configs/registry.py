"""``--arch`` name resolution for launchers, dry-runs, and tests."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(*, smoke: bool = False) -> Dict[str, ModelConfig]:
    return {n: get_config(n, smoke=smoke) for n in ARCH_NAMES}
