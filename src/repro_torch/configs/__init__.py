"""Architecture registry: every assigned config selectable via --arch.

Port of `repro.configs`: the same names, aliases and values.

Exact hyperparameters from the assignment sheet (sources in brackets in
each module docstring)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "rwkv6_3b",
    "llama3_2_3b",
    "phi3_medium_14b",
    "llama3_2_1b",
    "qwen3_0_6b",
    "jamba_v0_1_52b",
    "deepseek_v2_236b",
    "deepseek_moe_16b",
    "musicgen_large",
    "llama3_2_vision_90b",
    # extras (not on the assignment sheet)
    "lm_100m",      # example end-to-end training target
    "paper_hpo",    # the paper's own workload scale knobs
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({
    "rwkv6-3b": "rwkv6_3b",
    "llama3.2-3b": "llama3_2_3b",
    "phi3-medium-14b": "phi3_medium_14b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-0.6b": "qwen3_0_6b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "musicgen-large": "musicgen_large",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
})

ASSIGNED = [a for a in ARCHS if a not in ("lm_100m", "paper_hpo")]


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIAS.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
