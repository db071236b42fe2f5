"""Architecture registry: one module per assigned arch (``--arch <id>``),
the same data as `repro.configs` on the port's `ModelConfig`."""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "pixtral-12b",
    "recurrentgemma-2b",
    "yi-6b",
    "qwen2-0.5b",
    "qwen1.5-32b",
    "gemma-7b",
    "whisper-small",
    "falcon-mamba-7b",
    "deepseek-moe-16b",
    "grok-1-314b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str, reduced: bool = False):
    """Load the full (or reduced smoke-test) ModelConfig for an arch id."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False):
    return {a: get_config(a, reduced) for a in ARCH_IDS}
