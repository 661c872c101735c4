"""Architecture registry: one module per assigned arch.

Each module defines CONFIG (the exact published dims) and SMOKE (a reduced
same-family variant for CPU tests).  `get("glm4-9b")`, `smoke("glm4-9b")`.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "glm4-9b",
    "h2o-danube-1.8b",
    "llama3.2-3b",
    "stablelm-1.6b",
    "llama4-maverick-400b-a17b",
    "grok-1-314b",
    "seamless-m4t-large-v2",
    "zamba2-2.7b",
    "falcon-mamba-7b",
    "internvl2-2b",
)

_MOD = {
    "glm4-9b": "glm4_9b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "llama3.2-3b": "llama3_2_3b",
    "stablelm-1.6b": "stablelm_1_6b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "grok-1-314b": "grok_1_314b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "zamba2-2.7b": "zamba2_2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-2b": "internvl2_2b",
}


def _module(arch: str):
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MOD)}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
